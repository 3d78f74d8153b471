"""The port's planner (``kubedl_tpu_torch/planner/``, ``api/topology.py``)
against the reference's, on the CPU.

Parity: every entry of the reference's ``SLICE_CATALOG`` is rebuilt field
for field as the port's ``SliceTopology``; on each, for every
``MODEL_ZOO`` model and 1 or 2 slices, the port's ``enumerate_layouts``
gives the reference's list in the reference's order, and ``estimate`` on
each layout, ``dp_baseline`` and ``plan`` give the same mesh, the same
candidate count and the same times and HBM within 1e-9 relative (the
formulas are the same float operations, so in practice equal); where the
reference raises, the port raises the same ``PlanError`` message. Then the
port's own catalog: the H100 node shapes, their rates, the replica axis
priced at InfiniBand's rate, and the calibration rule that keeps a TPU
MFU out of a GPU plan.
"""

import dataclasses
import json

import pytest

from kubedl_tpu.api import topology as rt
from kubedl_tpu import planner as rp
from kubedl_tpu.planner import costmodel as rc

from kubedl_tpu_torch.api import topology as pt
from kubedl_tpu_torch import planner as pp
from kubedl_tpu_torch.planner import costmodel as pc

REL = 1e-9
REF_TOPOS = sorted(rt.SLICE_CATALOG)
ZOO = sorted(rc.MODEL_ZOO)
H100 = ("h100-1", "h100-2", "h100-4", "h100-8")


def _port_topo(name):
    """The reference's catalog entry as the port's SliceTopology."""
    return pt.SliceTopology(**dataclasses.asdict(rt.SLICE_CATALOG[name]))


def _port_model(name):
    return pc.ModelDesc(**dataclasses.asdict(rc.MODEL_ZOO[name]))


def _close(a, b):
    if a is None or b is None:
        return a is b
    return a == pytest.approx(b, rel=REL, abs=0.0)


def _same_cost(r, p):
    assert p.mesh.axes == r.mesh.axes
    assert p.feasible == r.feasible and p.reason == r.reason
    for key in ("step_ms", "compute_ms", "comm_ms", "exposed_comm_ms",
                "hbm_gib"):
        assert _close(getattr(r, key), getattr(p, key)), key
    assert p.comm_ms_by_axis.keys() == r.comm_ms_by_axis.keys()
    for axis, ms in r.comm_ms_by_axis.items():
        assert _close(ms, p.comm_ms_by_axis[axis]), axis


def test_zoo_and_constants_are_the_references():
    assert {k: dataclasses.asdict(v) for k, v in pc.MODEL_ZOO.items()} == \
        {k: dataclasses.asdict(v) for k, v in rc.MODEL_ZOO.items()}
    for name in ("DTYPE_BYTES", "OPT_BYTES_PER_PARAM",
                 "MODEL_FLOPS_EFFICIENCY", "UPDATE_SHARDING",
                 "OVERLAP_FRACTION", "HBM_USABLE_FRACTION",
                 "ACT_SAVED_PER_LAYER", "ACT_MICROBATCH_SEQS",
                 "LOSS_CHUNK_POSITIONS"):
        assert getattr(pc, name) == getattr(rc, name), name
    import importlib

    # the packages' ``search`` is the function: import the modules by name
    rs = importlib.import_module("kubedl_tpu.planner.search")
    ps = importlib.import_module("kubedl_tpu_torch.planner.search")

    assert (ps.SLACK_RELATIVE, ps.SLACK_ABS_MS) == (rs.SLACK_RELATIVE,
                                                      rs.SLACK_ABS_MS)
    assert pt.MeshSpec.AXIS_ORDER == rt.MeshSpec.AXIS_ORDER


@pytest.mark.parametrize("num_slices", [1, 2])
@pytest.mark.parametrize("model_name", ZOO)
@pytest.mark.parametrize("topo_name", REF_TOPOS)
def test_layouts_estimates_and_plan_match_reference(topo_name, model_name,
                                                    num_slices):
    rtopo, ptopo = rt.SLICE_CATALOG[topo_name], _port_topo(topo_name)
    rmodel, pmodel = rc.MODEL_ZOO[model_name], _port_model(model_name)
    r_layouts = rp.enumerate_layouts(rmodel, rtopo, num_slices)
    p_layouts = pp.enumerate_layouts(pmodel, ptopo, num_slices)
    assert [m.axes for m in p_layouts] == [m.axes for m in r_layouts]
    for rm, pm in zip(r_layouts, p_layouts):
        _same_cost(rc.estimate(rmodel, rtopo, rm, num_slices),
                   pc.estimate(pmodel, ptopo, pm, num_slices))
    _same_cost(rp.dp_baseline(rmodel, rtopo, num_slices),
               pp.dp_baseline(pmodel, ptopo, num_slices))
    try:
        r = rp.plan(rmodel, rtopo, num_slices)
    except rp.PlanError as e:
        with pytest.raises(pp.PlanError) as ei:
            pp.plan(pmodel, ptopo, num_slices)
        assert str(ei.value) == str(e)
        return
    p = pp.plan(pmodel, ptopo, num_slices)
    assert p.mesh.axes == r.mesh.axes
    assert (p.topology, p.num_slices, p.candidates_evaluated) == \
        (r.topology, r.num_slices, r.candidates_evaluated)
    for key in ("step_time_ms", "compute_ms", "comm_ms", "exposed_comm_ms",
                "hbm_gib", "baseline_dp_ms"):
        assert _close(getattr(r, key), getattr(p, key)), key
    assert p.to_annotation() == r.to_annotation()
    strip = (lambda s: s[:s.rindex(" in ")])  # plan_ms is host time
    assert strip(p.summary()) == strip(r.summary())


@pytest.mark.parametrize("topo_name", REF_TOPOS)
def test_topology_helpers_match_reference(topo_name):
    """host_mesh / coordinates, MeshSpec.for_slice (value or message) and
    validate_mesh_for_slice on good and bad meshes."""
    rtopo, ptopo = rt.SLICE_CATALOG[topo_name], _port_topo(topo_name)
    assert ptopo.host_mesh() == rtopo.host_mesh()
    assert [ptopo.coordinates(h) for h in range(rtopo.hosts)] == \
        [rtopo.coordinates(h) for h in range(rtopo.hosts)]
    for tensor in (1, 2, 3, 4):
        for n in (1, 2):
            try:
                want = rt.MeshSpec.for_slice(rtopo, tensor, n).axes
            except ValueError as e:
                with pytest.raises(ValueError, match=str(e)):
                    pt.MeshSpec.for_slice(ptopo, tensor, n)
                continue
            got = pt.MeshSpec.for_slice(ptopo, tensor, n)
            assert got.axes == want
            assert got.to_env() == rt.MeshSpec(dict(want)).to_env()
    meshes = [{"data": rtopo.chips}, {"data": rtopo.chips, "model": 1},
              {"data": 0}, {"data": rtopo.chips * 2},
              {"replica": 2, "data": rtopo.chips}]
    for axes in meshes:
        for n in (1, 2):
            assert pt.validate_mesh_for_slice(pt.MeshSpec(dict(axes)), ptopo,
                                              n) == \
                rt.validate_mesh_for_slice(rt.MeshSpec(dict(axes)), rtopo, n)


@pytest.mark.parametrize("kw", [
    {"dtype": "int4", "global_batch": 0},
    {},
    {"params": 1000},
    {"layers": -1, "hidden": 64, "vocab": 0, "seq_len": 0},
    {"params": 5, "ffn": -3},
], ids=["bad-dtype-batch", "empty", "params-only", "negatives", "neg-ffn"])
def test_model_desc_validate_matches_reference(kw):
    r, p = rc.ModelDesc(**kw), pc.ModelDesc(**kw)
    assert p.validate("m") == r.validate("m")
    assert p.validate() == r.validate()
    if not r.validate():
        assert p.num_params() == r.num_params()
        assert p.flops_per_token() == r.flops_per_token()
        assert p.bytes_per_param() == r.bytes_per_param()


def test_reference_unit_cases_hold_for_the_port():
    """The reference's own formula pins (tests/test_planner.py), run on
    the port's functions with the reference's catalog entries."""
    assert pc.allreduce_bytes(4, 100.0) == pytest.approx(150.0)
    assert pc.allgather_bytes(4, 100.0) == pytest.approx(75.0)
    assert pc.reduce_scatter_bytes(4, 100.0) == pytest.approx(75.0)
    assert pc.allreduce_bytes(1, 100.0) == pc.allgather_bytes(1, 100.0) == 0
    topo, md = _port_topo("v5e-8"), pc.MODEL_ZOO["tiny"]
    mesh = pt.MeshSpec({"data": 8})
    assert pc.hbm_per_chip_gib(md, mesh, update_sharding=True) < \
        pc.hbm_per_chip_gib(md, mesh, update_sharding=False)
    legacy = pc.estimate(md, topo, mesh, update_sharding=False)
    assert legacy.exposed_comm_ms == pytest.approx(legacy.comm_ms)
    assert pp.search(md, topo).best.mesh.axes == {"data": 8}
    res = pp.search(md, topo)
    assert res.evaluated == len(res.ranked) + len(res.infeasible)
    assert pp.plan(pc.MODEL_ZOO["llama-1b"], topo).mesh.axes == {"data": 8}
    with pytest.raises(pp.PlanError, match="no memory-feasible layout"):
        pp.plan(pc.MODEL_ZOO["llama-1b"], _port_topo("cpu-1"))
    with pytest.raises(pp.PlanError):
        pp.plan(pc.ModelDesc(), topo)


# ---- the port's own catalog: H100 node shapes ---------------------------------

def test_h100_catalog_values():
    """One host's NVLink domain of 1, 2, 4 or 8 SXM cards at the data
    sheet's rates; the reference's CPU stand-ins kept as they are."""
    assert set(pt.SLICE_CATALOG) == set(H100) | {"cpu-1", "cpu-8"}
    for name in H100:
        t = pt.get_slice(name)
        assert t.chips == int(name.split("-")[1]) == t.chips_per_host
        assert (t.hosts, t.physical_mesh) == (1, (t.chips,))
        assert (t.peak_bf16_tflops, t.hbm_gbps, t.ici_gbps, t.dcn_gbps) == \
            (989.0, 3350.0, 450.0, 50.0)
        assert 79.0 <= t.hbm_gib_per_chip <= 80.0
    for name in ("cpu-1", "cpu-8"):
        assert dataclasses.asdict(pt.get_slice(name)) == \
            dataclasses.asdict(rt.get_slice(name))
    with pytest.raises(KeyError, match="unknown slice type"):
        pt.get_slice("v5e-8")
    assert pt.peak_flops_for_device_kind("NVIDIA H100 80GB HBM3") == 989e12
    assert pt.hbm_bandwidth_for_device_kind("NVIDIA H100 80GB HBM3") == \
        3350e9
    for kind in ("cpu", "", "TPU v5 lite", "NVIDIA A100-SXM4-80GB"):
        assert pt.peak_flops_for_device_kind(kind) == 0.0
        assert pt.hbm_bandwidth_for_device_kind(kind) == 0.0


@pytest.mark.parametrize("num_slices", [1, 2])
@pytest.mark.parametrize("model_name", ZOO)
@pytest.mark.parametrize("topo_name", H100)
def test_h100_shapes_plan_every_zoo_model(topo_name, model_name, num_slices):
    """Every H100 shape x zoo model x 1 or 2 nodes gives a plan that tiles
    the shape and fits its HBM, or a clean PlanError; with two nodes the
    replica axis is the slice count, priced at InfiniBand's rate."""
    topo, md = pt.get_slice(topo_name), pc.MODEL_ZOO[model_name]
    try:
        p = pp.plan(md, topo, num_slices)
    except pp.PlanError as e:
        assert "no memory-feasible layout" in str(e)
        assert not pp.dp_baseline(md, topo, num_slices).feasible
        return
    assert pt.validate_mesh_for_slice(p.mesh, topo, num_slices) is None
    assert p.hbm_gib <= topo.hbm_gib_per_chip * pc.HBM_USABLE_FRACTION
    assert p.step_time_ms == pytest.approx(p.compute_ms + p.exposed_comm_ms)
    if num_slices > 1:
        assert p.mesh.axes["replica"] == num_slices
        mesh = pt.MeshSpec.for_slice(topo, num_slices=num_slices)
        cost = pc.estimate(md, topo, mesh, num_slices)
        p_bytes = md.num_params() * md.bytes_per_param()
        want = pc.allreduce_bytes(num_slices, p_bytes) / (
            topo.dcn_gbps * 1e9) * 1e3
        if cost.feasible:
            assert cost.comm_ms_by_axis["replica"] == pytest.approx(want)
            intra = pc.estimate(md, topo, mesh, 1)
            assert intra.comm_ms_by_axis["replica"] == pytest.approx(
                want * topo.dcn_gbps / topo.ici_gbps)


# ---- calibration: no TPU MFU in a GPU plan ------------------------------------

def _write(path, doc):
    path.write_text(json.dumps(doc))


def test_calibration_ignores_tpu_artifacts_and_takes_nvidia_ones(tmp_path):
    tpu = {"parsed": {"detail": {"platform": "tpu", "mfu": 0.42}}}
    cpu = {"runs": [{"detail": {"platform": "cpu", "mfu": 0.3}}]}
    gpu = {"device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3"},
           "summary": {"mfu": {"median": 0.31}}}
    only_tpu = tmp_path / "tpu"
    only_tpu.mkdir()
    _write(only_tpu / "BENCH_r01.json", tpu)
    _write(only_tpu / "BENCH_r02.json", cpu)
    # the reference would take the TPU run's MFU; the port keeps its default
    assert rc.calibrated_flops_efficiency(str(only_tpu)) == (0.3,
                                                             "BENCH_r02.json")
    assert pc.calibrated_flops_efficiency(str(only_tpu)) == (
        pc.MODEL_FLOPS_EFFICIENCY, "default")
    mixed = tmp_path / "mixed"
    mixed.mkdir()
    _write(mixed / "BENCH_r01.json", gpu)
    _write(mixed / "BENCH_r02.json", tpu)  # newer, but a TPU run
    assert pc.calibrated_flops_efficiency(str(mixed)) == (0.31,
                                                          "BENCH_r01.json")
    # implausible GPU values are skipped as the reference skips them
    low = tmp_path / "low"
    low.mkdir()
    _write(low / "BENCH_r01.json", dict(gpu, summary={"mfu": 0.01}))
    assert pc.calibrated_flops_efficiency(str(low)) == (0.4, "default")


def test_calibration_on_the_repository_is_the_default():
    """Every artifact committed today is a TPU or CPU run."""
    pc._EFFICIENCY_CACHE.clear()
    assert pc.calibrated_flops_efficiency() == (0.4, "default")
