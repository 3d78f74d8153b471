"""Draft-k / verify-1 speculative decoding for the port's paged engine.

Port of ``kubedl_tpu/serving/speculative.py``. Decode is memory-bound:
every generated token re-reads the whole weight set for one row of
matmul work. A cheap *draft* proposes k tokens, the target scores the
whole proposal in one forward over the paged cache
(``llama.paged_verify``, the blocked kernel at S = k+1 on the card), the
longest prefix where the draft agrees with the target's greedy choice is
accepted, plus one bonus token. Every emitted token is the target's
argmax given only accepted history, so GREEDY output is identical to
plain decode by construction; speculation changes only how many
sequential forwards it takes.

Drafts are pluggable (``propose(context, k) -> list[int]``):

- :class:`NgramDraft` ("ngram", the default): prompt-lookup — match the
  context's tail n-gram against its earlier tokens and propose what
  followed. No model, no device time.
- :class:`RepeatDraft` ("repeat"): the last token k times.
- :class:`ScriptedDraft`: tests force exact proposal streams.
- :class:`ModelDraft` ("model"): greedy-decode k tokens from a smaller
  model in its own contiguous cache (one batched prefill + one decode
  segment a round); :meth:`ModelDraft.from_target` carves an early-exit
  draft out of the target's first layers (views, no copies), and
  :meth:`ModelDraft.from_zoo` builds a trainable draft of its own shaped
  by the planner's model zoo ("zoo:<name>"), which :func:`distill_draft`
  trains on the target's greedy rollouts.

Multi-candidate verify (:meth:`DraftModel.propose_candidates`, scored by
the read-only ``llama.paged_verify_multi``) and tree speculation
(:class:`DraftTree`, scored by ``llama.paged_verify_tree``) re-verify
only the winner through the write path, so emitted tokens stay the
target's argmax.

"""

from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

class DraftModel:
    """Protocol for draft proposers (duck-typed; subclassing optional)."""

    name = "draft"

    def propose(self, context: Sequence[int], k: int) -> List[int]:
        """Return up to ``k`` proposed continuation tokens for
        ``context`` (prompt + generated so far). Shorter lists are
        allowed — the engine pads the verify window with repeats of the
        last proposal and simply accepts less."""
        raise NotImplementedError

    def propose_batch(
        self, contexts: Sequence[Sequence[int]], k: int
    ) -> List[List[int]]:
        """Batched :meth:`propose` (one call per verify tick). Model
        drafts override this to amortize their forward across rows."""
        return [self.propose(ctx, k) for ctx in contexts]

    def propose_candidates(
        self, context: Sequence[int], k: int, n: int
    ) -> List[List[int]]:
        """Up to ``n`` candidate continuations for multi-candidate
        verify. Candidate 0 MUST be the plain :meth:`propose` output —
        the engine relies on that to guarantee multi-candidate never
        accepts fewer tokens than the single-candidate path."""
        return [self.propose(context, k)]


class RepeatDraft(DraftModel):
    """Propose the last context token k times: the zero-knowledge
    baseline. Wins exactly on run-length repetition."""

    name = "repeat"

    def propose(self, context: Sequence[int], k: int) -> List[int]:
        if not context:
            return []
        return [int(context[-1])] * k


class NgramDraft(DraftModel):
    """Self-speculative prompt-lookup decoding: find the most recent
    earlier occurrence of the context's tail ``n``-gram (longest match
    first, down to 1) and propose the tokens that followed it. The
    context IS the draft model — no weights, no device time."""

    name = "ngram"

    def __init__(self, max_ngram: int = 3, window: int = 1024) -> None:
        self.max_ngram = max(1, int(max_ngram))
        self.window = max(8, int(window))

    def propose(self, context: Sequence[int], k: int) -> List[int]:
        ctx = [int(t) for t in context[-self.window:]]
        n_ctx = len(ctx)
        if n_ctx < 2:
            return []
        for n in range(min(self.max_ngram, n_ctx - 1), 0, -1):
            tail = ctx[n_ctx - n:]
            # scan for the most recent PRIOR occurrence of the tail
            for i in range(n_ctx - n - 1, -1, -1):
                if ctx[i:i + n] == tail:
                    out = ctx[i + n:i + n + k]
                    if out:
                        return out
                    break
        # no lookup hit: fall back to run-length repetition
        return [ctx[-1]] * k


class ScriptedDraft(DraftModel):
    """Deterministic proposal stream for tests: pops pre-seeded
    proposals in order, then falls back to repeats."""

    name = "scripted"

    def __init__(self, proposals: Sequence[Sequence[int]]) -> None:
        self._q = deque([list(p) for p in proposals])

    def propose(self, context: Sequence[int], k: int) -> List[int]:
        if self._q:
            return [int(t) for t in self._q.popleft()][:k]
        return RepeatDraft().propose(context, k)


class ModelDraft(DraftModel):
    """Small-model draft: greedy-decode ``k`` tokens from its own
    weights. Each proposal round is one batched prefill over the rows'
    recent context windows plus one greedy decode segment in a FRESH
    contiguous cache (the draft is small enough that re-prefilling a
    bounded window every round beats keeping per-row draft caches
    coherent with the target's accept/rewind churn). Context lengths are
    padded to ``pad_to`` multiples and the batch to a power of two, as in
    the reference (the same shapes, so the same proposals)."""

    name = "model"

    def __init__(self, params, cfg, max_context: int = 512,
                 pad_to: int = 32) -> None:
        from kubedl_tpu_torch.models import llama

        self.params = params
        self.cfg = cfg
        self.max_context = min(int(max_context), cfg.max_seq)
        self.pad_to = max(8, int(pad_to))
        self._llama = llama

    @property
    def device(self) -> torch.device:
        e = self.params["embed"]
        return (e["q8"] if isinstance(e, dict) else e).device

    @classmethod
    def from_target(cls, params, cfg, n_layers: int,
                    **kwargs) -> "ModelDraft":
        """Early-exit draft: the target's first ``n_layers`` decoder
        layers (slices of the stacked [L, ...] tensors — views, no
        copies) with the shared embedding / final norm / lm head."""
        from kubedl_tpu_torch.models.llama import map_leaves

        n = max(1, min(int(n_layers), cfg.n_layers))
        draft_params = {k: v for k, v in params.items() if k != "layers"}
        # int8 leaves ({"q8", "s8"}) are sliced leaf by leaf
        draft_params["layers"] = map_leaves(lambda a: a[:n],
                                            params["layers"])
        return cls(draft_params, dataclasses.replace(cfg, n_layers=n),
                   **kwargs)

    @classmethod
    def from_zoo(cls, name: str, target_cfg, seed: int = 0,
                 ckpt_path: Optional[str] = None, device=None,
                 **kwargs) -> "ModelDraft":
        """A *trainable* small draft shaped by the planner's MODEL_ZOO
        entry ``name``: its own weights, not a slice of the target's.
        Vocab / max_seq / dtype come from the target (the draft proposes
        target tokens); depth and widths from the zoo entry, with
        ``hidden // 64`` heads, as many kv-heads. Fresh weights (seeded
        ``llama_init`` on ``device``, the card unless the caller asks for
        the CPU) propose noise; ``ckpt_path`` restores a :meth:`save`
        file (the reference's too), e.g. after :func:`distill_draft`."""
        from kubedl_tpu_torch import resolve_device
        from kubedl_tpu_torch.models import llama
        from kubedl_tpu_torch.planner.costmodel import MODEL_ZOO

        try:
            desc = MODEL_ZOO[name]
        except KeyError:
            raise ValueError(
                f"unknown zoo draft {name!r} (have: {sorted(MODEL_ZOO)})"
            ) from None
        heads = max(1, desc.hidden // 64)
        cfg = llama.LlamaConfig(
            vocab_size=target_cfg.vocab_size, dim=desc.hidden,
            n_layers=desc.layers, n_heads=heads, n_kv_heads=heads,
            ffn_dim=desc.ffn, max_seq=target_cfg.max_seq,
            dtype=target_cfg.dtype, remat=False,
        )
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        draft = cls(llama.llama_init(cfg, gen, dev), cfg, **kwargs)
        draft.name = f"zoo:{name}"
        if ckpt_path:
            draft.load(ckpt_path)
        return draft

    def save(self, path: str) -> None:
        """Flat-npz draft checkpoint, leaves in the reference's tree order
        (dict keys sorted, as ``jax.tree_util.tree_leaves`` orders them),
        so the two packages read each other's files. bf16 leaves are
        written as float32 (exact)."""
        from kubedl_tpu_torch.training.trainer import tree_leaves

        np.savez(path, **{
            f"leaf_{i}": leaf.detach().float().cpu().numpy()
            if leaf.dtype == torch.bfloat16 else leaf.detach().cpu().numpy()
            for i, leaf in enumerate(tree_leaves(self.params))
        })

    def load(self, path: str) -> None:
        """Restore :meth:`save` output into the existing param tree
        (shapes must match), as owned tensors on the draft's device."""
        from kubedl_tpu_torch.training.trainer import (
            tree_leaves, tree_unflatten,
        )

        leaves = tree_leaves(self.params)
        new = []
        with np.load(path) as z:
            for i, old in enumerate(leaves):
                arr = z[f"leaf_{i}"]
                if tuple(arr.shape) != tuple(old.shape):
                    raise ValueError(
                        f"draft checkpoint leaf {i} shape {arr.shape} != "
                        f"model shape {tuple(old.shape)}"
                    )
                new.append(torch.tensor(np.asarray(arr, np.float32)).to(
                    device=old.device, dtype=old.dtype))
        self.params = tree_unflatten(self.params, new)

    def _prefill_padded(self, contexts: Sequence[Sequence[int]], k: int):
        """Left-truncate each context to the draft window, right-pad to
        a shape bucket, run one batched prefill. Returns (last-token
        logits [Bp, V], cache, B)."""
        llama = self._llama
        dev = self.device
        B = len(contexts)
        Bp = 1
        while Bp < B:
            Bp *= 2
        win = max(1, self.max_context - k - 1)
        ctxs = [list(map(int, c))[-win:] for c in contexts]
        P = max(max((len(c) for c in ctxs), default=1), 1)
        P = ((P + self.pad_to - 1) // self.pad_to) * self.pad_to
        toks = np.zeros((Bp, P), np.int32)
        lens = np.zeros((Bp,), np.int32)
        for b, c in enumerate(ctxs):
            toks[b, :len(c)] = c
            lens[b] = len(c)
        cache = llama.init_batched_cache(self.cfg, Bp, self.max_context, dev)
        logits, cache = llama.prefill_batched(
            self.params, cache, torch.tensor(toks).to(dev),
            torch.tensor(lens).to(dev), self.cfg,
        )
        return logits, cache, B

    def _continue(self, cache, first: torch.Tensor, k: int) -> np.ndarray:
        """Greedy continuation of ``first`` [Bp] by k-1 steps; the ids
        [Bp, k] on the host (one copy a round)."""
        if k == 1:
            return first[:, None].cpu().numpy()
        Bp = first.shape[0]
        toks, _, _ = self._llama.decode_segment(
            self.params, cache, first[:, None],
            torch.zeros((Bp,), dtype=torch.float32, device=first.device),
            None, self.cfg, k - 1, greedy=True,
        )
        return torch.cat([first[:, None], toks], dim=1).cpu().numpy()

    def propose(self, context: Sequence[int], k: int) -> List[int]:
        return self.propose_batch([context], k)[0]

    @torch.no_grad()
    def propose_batch(
        self, contexts: Sequence[Sequence[int]], k: int
    ) -> List[List[int]]:
        if k <= 0 or not contexts:
            return [[] for _ in contexts]
        logits, cache, B = self._prefill_padded(contexts, k)
        first = torch.argmax(logits, dim=-1).to(torch.int32)  # [Bp]
        ids = self._continue(cache, first, k)
        return [[int(t) for t in ids[b]] for b in range(B)]

    @torch.no_grad()
    def propose_candidates(
        self, context: Sequence[int], k: int, n: int
    ) -> List[List[int]]:
        """Branch at the first token: the draft's top-``n`` first tokens
        (descending — candidate 0 is the greedy proposal), each continued
        greedily. One prefill over n identical rows, one segment."""
        if n <= 1 or k <= 0:
            return [self.propose(context, k)]
        logits, cache, _ = self._prefill_padded([context] * n, k)
        firsts = torch.topk(logits[0], n).indices.to(torch.int32)  # [n]
        Bp = logits.shape[0]
        firsts_full = torch.cat([firsts, torch.zeros(
            (Bp - n,), dtype=torch.int32, device=firsts.device)])
        ids = self._continue(cache, firsts_full, k)
        return [[int(t) for t in ids[i]] for i in range(n)]


class DraftTree:
    """Prefix trie over candidate draft chains for tree speculation.

    Node 0 is the ROOT: the row's next verify input (its last accepted
    token), depth 0. Every other node is one proposed draft token; a
    node's root path spells one draft prefix, and chains that share a
    prefix share nodes — the whole reason the trie beats the flat
    multi-candidate layout. :meth:`arrays` emits the fixed-size
    (tokens, depth, ancestor-mask) layout `llama.paged_verify_tree`
    consumes; :meth:`walk` follows the target's greedy ids down the
    trie to the deepest accepted path."""

    __slots__ = ("tokens", "parents", "depth", "children")

    def __init__(self, root_token: int) -> None:
        self.tokens: List[int] = [int(root_token)]
        self.parents: List[int] = [-1]
        self.depth: List[int] = [0]
        self.children: List[Dict[int, int]] = [{}]

    @property
    def size(self) -> int:
        return len(self.tokens)

    def insert(self, chain: Sequence[int], m_max: int) -> None:
        """Merge one candidate chain into the trie, capped at ``m_max``
        total nodes (excess suffix tokens are dropped — never verified,
        never emitted, so the cap only costs acceptance length)."""
        cur = 0
        for t in chain:
            t = int(t)
            nxt = self.children[cur].get(t)
            if nxt is None:
                if len(self.tokens) >= m_max:
                    return
                nxt = len(self.tokens)
                self.tokens.append(t)
                self.parents.append(cur)
                self.depth.append(self.depth[cur] + 1)
                self.children.append({})
                self.children[cur][t] = nxt
            cur = nxt

    def arrays(self, m_max: int):
        """Fixed-shape verify inputs: ``(tokens [m_max], depth [m_max],
        mask [m_max, m_max])`` numpy arrays. ``mask[m, t]`` is True iff
        t is m or an ancestor of m. Pad nodes repeat the root token as
        depth-1 children of the root: well-formed rows whose outputs the
        walk never reads, and — the masks being per-node — invisible to
        every live node's attention."""
        M = len(self.tokens)
        if M > m_max:
            raise ValueError(f"trie size {M} exceeds m_max {m_max}")
        toks = np.full((m_max,), self.tokens[0], np.int32)
        dep = np.ones((m_max,), np.int32)
        mask = np.zeros((m_max, m_max), bool)
        toks[:M] = self.tokens
        dep[:M] = self.depth
        for m in range(M):
            a = m
            while a != -1:
                mask[m, a] = True
                a = self.parents[a]
        for m in range(M, m_max):
            mask[m, m] = True
            mask[m, 0] = True
        return toks, dep, mask

    def walk(self, ids: Sequence[int]) -> List[int]:
        """Deepest accepted path: starting at the root, repeatedly step
        to the child whose token equals the target's greedy continuation
        ``ids[cur]`` at the current node; stop when no child matches.
        Returns the accepted DRAFT tokens along that path (root
        excluded) — `accept_length` over a chain trie, exactly."""
        path: List[int] = []
        cur = 0
        while True:
            nxt = self.children[cur].get(int(ids[cur]))
            if nxt is None:
                return path
            path.append(self.tokens[nxt])
            cur = nxt


def build_tree(
    root_token: int, chains: Sequence[Sequence[int]], k: int, m_max: int
) -> DraftTree:
    """Fold candidate ``chains`` (each ≤ k draft tokens) into one
    :class:`DraftTree`, inserting in order so candidate 0 — the greedy
    proposal — is never the one truncated by the node cap."""
    tree = DraftTree(root_token)
    for c in chains:
        tree.insert([int(t) for t in c][:k], m_max)
    return tree


def distill_draft(draft: "ModelDraft", target_params, target_cfg,
                  prompts: Sequence[Sequence[int]], gen_len: int = 16,
                  steps: int = 40, lr: float = 1e-2) -> List[float]:
    """Train ``draft`` to imitate the target's GREEDY rollouts: the
    target (a :class:`ModelDraft` over its weights: one batched prefill
    and one greedy segment) continues every prompt by ``gen_len`` tokens,
    the sequences are cut to the shortest, and the draft takes ``steps``
    of the next-token loss under ``optax.adam(lr)``
    (:class:`~kubedl_tpu_torch.ops.adamw.Adam`: the optimizer kernels on
    the card). Hard-label distillation is exactly the objective greedy
    acceptance scores. Trains ``draft.params`` in place, after binding
    copies of any leaf that shares storage with ``target_params`` (the
    target is left as it was), and returns the per-step losses. On the card the loss takes the flash operators where
    they tile the length, as the trainer's "auto" does; on the CPU the
    plain attention, the reference's."""
    from kubedl_tpu_torch.models import llama
    from kubedl_tpu_torch.ops import flash_attention as fa
    from kubedl_tpu_torch.ops.adamw import Adam
    from kubedl_tpu_torch.training.trainer import tree_leaves, tree_unflatten

    teacher = ModelDraft(target_params, target_cfg,
                         max_context=target_cfg.max_seq)
    conts = teacher.propose_batch(prompts, gen_len)
    del teacher
    seqs = [list(map(int, p)) + c for p, c in zip(prompts, conts)]
    L = min(len(s) for s in seqs)
    dev = draft.device
    toks = torch.tensor([s[:L] for s in seqs], dtype=torch.int32).to(dev)
    attn_fn = (fa.make_flash_attention()
               if dev.type == "cuda" and fa.supports(L) else None)
    # the reference binds new arrays to draft.params and leaves the
    # target as it was; an early-exit draft's leaves are the target's
    # tensors (or views of them), so they are copied before training
    shared = {t.untyped_storage().data_ptr()
              for t in tree_leaves(target_params)}
    leaves = [p.clone() if p.untyped_storage().data_ptr() in shared else p
              for p in tree_leaves(draft.params)]
    draft.params = tree_unflatten(draft.params, leaves)
    opt = Adam(leaves, lr)
    losses = []
    try:
        for p in leaves:
            p.requires_grad_(True)
        for _ in range(max(1, int(steps))):
            loss = llama.llama_loss(draft.params, toks, draft.cfg, attn_fn)
            opt.step(torch.autograd.grad(loss, leaves))
            losses.append(loss.detach())
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return [float(x) for x in losses]


_DRAFTS = {
    "ngram": NgramDraft,
    "repeat": RepeatDraft,
}


def make_draft(name: str, **kwargs) -> DraftModel:
    """Draft factory for the engine's ``spec_draft`` knob. "model"
    needs weights — the engine constructs :class:`ModelDraft` itself
    (`ModelDraft.from_target`) instead of going through here."""
    if name == "model":
        raise ValueError(
            "draft 'model' needs target weights: use "
            "ModelDraft.from_target(...) (the engine's spec_draft="
            "'model' path does this)"
        )
    try:
        return _DRAFTS[name](**kwargs)
    except KeyError:
        raise ValueError(
            f"unknown draft {name!r} (have: {sorted(_DRAFTS)})"
        ) from None


def accept_length(drafts: Sequence[int], greedy_ids: Sequence[int]) -> int:
    """Longest agreeing prefix: number of draft tokens ``a`` such that
    ``drafts[j] == greedy_ids[j]`` for all ``j < a`` (greedy_ids[j] is
    the target's argmax after consuming the j-th verify input). The
    engine emits ``greedy_ids[:a+1]`` — a accepted drafts plus the bonus
    token, every one of them the target's own greedy choice."""
    a = 0
    for d, g in zip(drafts, greedy_ids):
        if int(d) != int(g):
            break
        a += 1
    return a


class SpecStats:
    """Acceptance accounting shared by the engine, stats(), and
    /metrics. ``accepted``/``proposed`` count DRAFT tokens (the bonus
    token is not a draft — a 0-acceptance verify still emits one token);
    ``window`` keeps recent per-verify acceptance lengths for the
    distribution tests and the p50 the autoscaler reads."""

    def __init__(self, maxlen: int = 4096) -> None:
        self._lock = threading.Lock()
        self.proposed = 0
        self.accepted = 0
        self.verifies = 0
        self.emitted = 0
        self.candidates_scored = 0
        self.candidate_switches = 0
        self.draft_ms_total = 0.0
        self.window: "deque[int]" = deque(maxlen=maxlen)
        self.draft_ms_window: "deque[float]" = deque(maxlen=maxlen)

    def record(self, proposed: int, accepted: int, emitted: int) -> None:
        with self._lock:
            self.proposed += int(proposed)
            self.accepted += int(accepted)
            self.verifies += 1
            self.emitted += int(emitted)
            self.window.append(int(accepted))

    def record_draft_ms(self, ms: float) -> None:
        """Wall time of one draft proposal round (all rows)."""
        with self._lock:
            self.draft_ms_total += float(ms)
            self.draft_ms_window.append(float(ms))

    def record_candidates(self, scored: int, switched: bool) -> None:
        """One multi-candidate verify: ``scored`` candidates ranked,
        ``switched`` = the winner was NOT the greedy candidate 0."""
        with self._lock:
            self.candidates_scored += int(scored)
            self.candidate_switches += 1 if switched else 0

    def acceptance_rate(self) -> float:
        with self._lock:
            return self.accepted / self.proposed if self.proposed else 0.0

    def snapshot(self) -> Dict:
        with self._lock:
            win = list(self.window)
            out = {
                "proposed": self.proposed,
                "accepted": self.accepted,
                "verifies": self.verifies,
                "emitted": self.emitted,
                "candidates_scored": self.candidates_scored,
                "candidate_switches": self.candidate_switches,
                "draft_ms_total": round(self.draft_ms_total, 3),
            }
            dwin = list(self.draft_ms_window)
        if dwin:
            out["draft_ms_p50"] = sorted(dwin)[len(dwin) // 2]
        out["acceptance_rate"] = round(
            out["accepted"] / out["proposed"], 4
        ) if out["proposed"] else 0.0
        out["tokens_per_verify"] = round(
            out["emitted"] / out["verifies"], 4
        ) if out["verifies"] else 0.0
        if win:
            srt = sorted(win)
            out["accept_len_p50"] = srt[len(srt) // 2]
            out["accept_len_mean"] = round(sum(win) / len(win), 4)
        return out


__all__ = [
    "DraftModel", "NgramDraft", "RepeatDraft", "ScriptedDraft",
    "ModelDraft", "make_draft", "accept_length", "SpecStats",
    "DraftTree", "build_tree", "distill_draft",
]
