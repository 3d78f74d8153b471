"""Guards on the PyTorch port's boundaries: it never imports JAX, optax
or the JAX package, it never falls back to the CPU on its own, and the
engine and the trainer reject what the port does not run yet instead of
ignoring it."""

import ast
import ctypes
import json
import re
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "kubedl_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
]


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_never_imports_jax_or_the_jax_package(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "kubedl_tpu", "flax", "optax"), \
            f"{path.name} imports {mod}"


def test_port_files_found():
    names = {p.name for p in PORT_FILES}
    assert {"llama.py", "paged_attention.py", "server.py", "kv_blocks.py",
            "build.py", "chip_smoke.py", "flash_attention.py", "trainer.py",
            "entry.py", "topology.py", "data.py"} <= names


def test_engine_without_device_raises_when_no_cuda(monkeypatch):
    from kubedl_tpu_torch.serving.server import LlamaEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaEngine(preset="tiny")
    with pytest.raises(RuntimeError):
        LlamaEngine(preset="tiny", device="cuda")


def test_trainer_without_device_raises_when_no_cuda(monkeypatch):
    from kubedl_tpu_torch.training.trainer import TrainConfig, Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(TrainConfig())
    assert Trainer(TrainConfig(), device="cpu").device.type == "cpu"


def test_resolve_device_rule(monkeypatch):
    from kubedl_tpu_torch import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(RuntimeError):
        resolve_device(None)
    with pytest.raises(ValueError):
        resolve_device("meta")


@pytest.mark.parametrize("kw", [
    {"quantize": "int8"},
    {"mesh_axes": {"tensor": 2}},
    {"spec_k": 4},
    {"prefix_cache_mb": 64.0},
    {"kv_layout": "contiguous"},
    {"role": "prefill"},
    {"role": "decode"},
    {"ckpt_dir": "/nonexistent"},
    {"kv_attention": "dense"},
    {"kv_layout": "ragged"},
], ids=lambda kw: next(iter(kw)) + "=" + str(next(iter(kw.values()))))
def test_unsupported_engine_knobs_raise(kw):
    from kubedl_tpu_torch.serving.server import LlamaEngine

    with pytest.raises(ValueError):
        LlamaEngine(preset="tiny", device="cpu", max_seq=64, **kw)


def test_hot_swap_raises_naming_later_slice():
    from kubedl_tpu_torch.serving.server import LlamaEngine

    eng = LlamaEngine(preset="tiny", device="cpu", max_seq=64)
    try:
        for call in (lambda: eng.load_version("v2", "/x"),
                     lambda: eng.activate_version("v2"),
                     lambda: eng.retire_version("v2")):
            with pytest.raises(ValueError, match="later port slice"):
                call()
    finally:
        eng.close()


def test_serve_main_rejects_chaos(monkeypatch):
    from kubedl_tpu_torch.serving import server

    monkeypatch.setenv("KUBEDL_SERVE_CONFIG",
                       json.dumps({"chaos": {"seed": 1, "sites": {}}}))
    with pytest.raises(ValueError, match="later port slice"):
        server.serve_main({})


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """The build runs only when a kernel is launched; without nvcc it
    raises rather than falling back to anything."""
    from kubedl_tpu_torch.ops import build

    monkeypatch.setenv("NVCC", str(tmp_path / "missing-nvcc"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build.shutil, "which", lambda _name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()
    assert build.NVCC_FLAGS[:2] == ("-gencode", "arch=compute_90a,code=sm_90a")


def test_chip_smoke_refuses_without_cuda(monkeypatch):
    """chip_smoke.py exits non-zero, printing no result, with no card."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_test", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", ["chip_smoke.py"])
    assert mod.main() != 0


# ---- the ctypes bindings against the C entry points ---------------------------

def _c_entry_points() -> dict:
    """``{name: [param, ...]}`` of every ``extern "C" int kdl_*(...)`` in
    the port's CUDA sources."""
    found = {}
    for src in sorted((ROOT / "kubedl_tpu_torch" / "csrc").glob("*.cu")):
        text = re.sub(r"//[^\n]*", "", src.read_text())
        for m in re.finditer(r'extern\s+"C"\s+int\s+(kdl_\w+)\s*\(([^)]*)\)',
                             text):
            found[m.group(1)] = [" ".join(a.split())
                                 for a in m.group(2).split(",")]
    return found


C_ENTRY_POINTS = _c_entry_points()


class _StandIn:
    """Takes the ``argtypes`` / ``restype`` a ``_declare_*`` sets."""

    def __init__(self):
        self.fns = {}

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return self.fns.setdefault(name, types.SimpleNamespace())


def _declared() -> dict:
    from kubedl_tpu_torch.ops import build

    lib = _StandIn()
    for declare in build._SOURCES.values():
        declare(lib)
    return lib.fns


def test_every_declared_entry_point_exists_in_the_sources():
    assert len(C_ENTRY_POINTS) >= 6
    assert set(_declared()) == set(C_ENTRY_POINTS)


@pytest.mark.parametrize("name", sorted(C_ENTRY_POINTS))
def test_ctypes_declaration_matches_c_signature(name):
    """Same argument count; every pointer (and the stream) c_void_p, every
    int c_int: a pointer passed as a 32-bit int would be cut."""
    fn = _declared()[name]
    params = C_ENTRY_POINTS[name]
    assert len(fn.argtypes) == len(params), (name, params)
    for param, declared in zip(params, fn.argtypes):
        if "*" in param:
            assert declared is ctypes.c_void_p, (name, param)
        else:
            assert param.split()[0] == "int", (name, param)
            assert declared is ctypes.c_int, (name, param)
    assert fn.restype is ctypes.c_int
