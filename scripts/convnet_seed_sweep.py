"""Why the port's convnet ``fit`` stalls from some seeds: a CPU sweep.

    JAX_PLATFORMS=cpu python3 scripts/convnet_seed_sweep.py

Trains the convnet at width 8, hidden 32 (the reference test's size) for
200 steps of ``optax.adam(1e-3)`` (``fit``'s defaults) with batch 64, on
the CPU, crossing what can differ between the two packages:

- the loop: the port's ``kubedl_tpu_torch.models.convnet.fit`` or the
  reference's ``kubedl_tpu.models.convnet.fit``;
- the initial parameters: the port's ``convnet_init`` from a
  ``torch.Generator`` or the reference's from ``jax.random.PRNGKey``,
  carried across packages as they are;
- the data: each package's own ``SyntheticDigits`` (the same task drawn
  from two random streams), and the reference's batches fed to the
  port's loop.

Prints one line a case: the final training loss and the held-out
accuracy on 256 draws of seed 7 from the data's own package. Then the
port's loop from init seed 2 on its own data at other template seeds,
and from init seeds 6-15 on its own data.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import torch  # noqa: E402

from kubedl_tpu.models import convnet as jc  # noqa: E402
from kubedl_tpu_torch.models import convnet as tc  # noqa: E402

STEPS, BATCH = 200, 64
CFG_T = tc.ConvNetConfig(width=8, hidden=32)
CFG_J = jc.ConvNetConfig(width=8, hidden=32)


def t_init(seed):
    return tc.convnet_init(torch.Generator().manual_seed(seed), CFG_T, "cpu")


def j_init(seed):
    return jc.convnet_init(jax.random.PRNGKey(seed), CFG_J)


def j2t(p):
    return {k: torch.tensor(np.asarray(v)) for k, v in p.items()}


def t2j(p):
    return {k: jax.numpy.asarray(v.numpy()) for k, v in p.items()}


def port_on_port_data(params, data_seed, template_seed=1234):
    data = tc.SyntheticDigits(CFG_T, BATCH, seed=data_seed,
                              template_seed=template_seed, device="cpu")
    p, s = tc.fit(CFG_T, iter(data), steps=STEPS, params=params,
                  device="cpu")
    imgs, labels = next(tc.SyntheticDigits(CFG_T, 256, seed=7,
                                           template_seed=template_seed,
                                           device="cpu"))
    return s["final_loss"], tc.accuracy(p, imgs, labels, CFG_T)


def port_on_ref_data(params, data_seed):
    it = jc.SyntheticDigits(CFG_J, batch=BATCH, seed=data_seed)
    batches = [(torch.tensor(np.asarray(a)), torch.tensor(np.asarray(b)))
               for a, b in (next(it) for _ in range(STEPS))]
    p, s = tc.fit(CFG_T, iter(batches), steps=STEPS, params=params,
                  device="cpu")
    imgs, labels = next(iter(jc.SyntheticDigits(CFG_J, 256, seed=7)))
    return s["final_loss"], tc.accuracy(
        p, torch.tensor(np.asarray(imgs)), torch.tensor(np.asarray(labels)),
        CFG_T)


def ref_on_ref_data(params, data_seed):
    data = jc.SyntheticDigits(CFG_J, batch=BATCH, seed=data_seed)
    p, s = jc.fit(CFG_J, iter(data), steps=STEPS, params=params)
    imgs, labels = next(iter(jc.SyntheticDigits(CFG_J, 256, seed=7)))
    return s["final_loss"], float(jc.accuracy(p, imgs, labels, CFG_J))


def main() -> int:
    torch.set_num_threads(4)
    for init in range(6):
        for data in (0, 1):
            print(json.dumps({
                "init": init, "data": data,
                "port_loop_port_data_port_init": port_on_port_data(
                    t_init(init), data),
                "port_loop_port_data_ref_init": port_on_port_data(
                    j2t(j_init(init)), data),
                "port_loop_ref_data_port_init": port_on_ref_data(
                    t_init(init), data),
                "port_loop_ref_data_ref_init": port_on_ref_data(
                    j2t(j_init(init)), data),
                "ref_loop_ref_data_port_init": ref_on_ref_data(
                    t2j(t_init(init)), data),
                "ref_loop_ref_data_ref_init": ref_on_ref_data(
                    j_init(init), data)}), flush=True)
    print(json.dumps({"port_init_2_by_template_seed": {
        ts: port_on_port_data(t_init(2), 0, ts) for ts in (1234, 1, 2, 3)}}),
        flush=True)
    print(json.dumps({"port_inits_6_15_port_data_0": {
        s: port_on_port_data(t_init(s), 0) for s in range(6, 16)}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
