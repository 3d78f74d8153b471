"""The port's compile cache (``kubedl_tpu_torch/utils/compile_cache.py``):
its kernel builds behind ``KUBEDL_COMPILE_CACHE_DIR``, on the CPU.

The CPU tests run without ``nvcc``, so a fake one (``NVCC``, a script in
``tmp_path``) writes a fixed number of bytes to its ``-o`` file: what is
tested is where builds go, what a process counts as hits and misses,
that a second process with the same tree compiles nothing and adds no
entry, the LRU bound, and the refusal of a directory it cannot write.
The reference's summary keys come from ``train_main`` on the CPU.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from kubedl_tpu_torch.ops import build
from kubedl_tpu_torch.utils import compile_cache as cc

ROOT = Path(__file__).resolve().parents[1]
SOURCES = sorted(name + ".cu" for name in build._SOURCES)
LIB_BYTES = 1000


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """An ``nvcc`` that writes LIB_BYTES bytes to its ``-o`` path."""
    script = tmp_path / "nvcc"
    script.write_text(textwrap.dedent(f"""\
        #!{sys.executable}
        import sys
        out = sys.argv[sys.argv.index("-o") + 1]
        with open(out, "wb") as f:
            f.write(b"x" * {LIB_BYTES})
        """))
    script.chmod(0o755)
    monkeypatch.setenv("NVCC", str(script))
    return script


@pytest.fixture
def fresh_build_state(monkeypatch):
    """This process's build state, restored afterwards (the cache dir is
    process-wide, as the reference's JAX setting is)."""
    monkeypatch.setattr(build, "_cache_dir", None)
    monkeypatch.setattr(build, "_cache_max_bytes", None)
    monkeypatch.setattr(build, "_used", set())
    monkeypatch.setattr(build, "BUILD_SECONDS", {})
    monkeypatch.setattr(build, "BUILD_LOG", {})
    monkeypatch.delenv(cc.ENV_COMPILE_CACHE_MAX_BYTES, raising=False)
    monkeypatch.delenv("KUBEDL_COMPILE_CACHE_DIR", raising=False)


def test_resolution_order_argument_env_default(tmp_path, monkeypatch,
                                               fresh_build_state):
    assert cc.enable_compilation_cache() == ""
    assert build.build_dir() == build.BUILD_DIR
    monkeypatch.setenv("KUBEDL_COMPILE_CACHE_DIR", str(tmp_path / "env"))
    assert cc.enable_compilation_cache() == str(tmp_path / "env")
    assert build.build_dir() == (tmp_path / "env").resolve()
    assert cc.enable_compilation_cache(str(tmp_path / "arg")) == \
        str(tmp_path / "arg")
    assert build.build_dir() == (tmp_path / "arg").resolve()
    assert (tmp_path / "arg").is_dir()
    # the build reads the directory at call time
    assert build._lib_path(build.CSRC_DIR / SOURCES[0]).parent == \
        (tmp_path / "arg").resolve()


def test_unwritable_directory_raises_naming_it(tmp_path, fresh_build_state):
    blocker = tmp_path / "a-file"
    blocker.write_text("not a directory")
    bad = blocker / "cache"
    with pytest.raises(RuntimeError, match=str(bad)):
        cc.enable_compilation_cache(str(bad))
    assert build.build_dir() == build.BUILD_DIR  # nothing moved quietly


_PROCESS = textwrap.dedent("""\
    import json
    from kubedl_tpu_torch.ops import build
    from kubedl_tpu_torch.utils import compile_cache as cc

    d = cc.enable_compilation_cache()
    before = cc.cache_entry_count(d)
    for name in sorted(n + ".cu" for n in build._SOURCES):
        build.build(name)
    print(json.dumps({"before": before, "after": cc.cache_entry_count(d),
                      "events": cc.cache_events(),
                      "dir": str(build.build_dir())}))
    """)


def _process(cache_dir, nvcc):
    env = dict(os.environ, KUBEDL_COMPILE_CACHE_DIR=str(cache_dir),
               NVCC=str(nvcc), PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _PROCESS], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    return json.loads(out.strip().splitlines()[-1])


def test_cold_process_compiles_and_warm_process_only_loads(tmp_path,
                                                           fake_nvcc):
    """A cold process compiles every source (a miss each); a second,
    fresh process with the same tree loads every build (a hit each),
    compiles none and adds no entry."""
    cache = tmp_path / "cache"
    cold = _process(cache, fake_nvcc)
    assert cold["dir"] == str(cache.resolve())
    assert cold["events"] == {"hits": 0, "misses": len(SOURCES)}
    assert (cold["before"], cold["after"]) == (0, len(SOURCES))
    warm = _process(cache, fake_nvcc)
    assert warm["events"] == {"hits": len(SOURCES), "misses": 0}
    assert warm["before"] == warm["after"] == len(SOURCES)


def test_lru_eviction_past_the_bound(tmp_path, monkeypatch, fake_nvcc,
                                     fresh_build_state):
    """Past KUBEDL_COMPILE_CACHE_MAX_BYTES a new build evicts the least
    recently used builds this process has not loaded, oldest first."""
    cache = tmp_path / "cache"
    cache.mkdir()
    old = []
    for i, name in enumerate(("libold-a.so", "libold-b.so")):
        p = cache / name
        p.write_bytes(b"y" * LIB_BYTES)
        os.utime(p, (1000 + i, 1000 + i))  # a is the least recently used
        old.append(p)
    monkeypatch.setenv(cc.ENV_COMPILE_CACHE_MAX_BYTES, str(3 * LIB_BYTES))
    cc.enable_compilation_cache(str(cache))
    first = build.build(SOURCES[0])  # 3 builds: at the bound
    assert all(p.exists() for p in old + [first])
    second = build.build(SOURCES[1])  # 4: the oldest unused goes
    assert not old[0].exists() and old[1].exists()
    assert first.exists() and second.exists()
    monkeypatch.setenv(cc.ENV_COMPILE_CACHE_MAX_BYTES, str(LIB_BYTES))
    cc.enable_compilation_cache(str(cache))
    third = build.build(SOURCES[2])
    # only what this process used is left, though it is over the bound
    assert not old[1].exists()
    assert {p.name for p in cache.glob("lib*.so")} == \
        {first.name, second.name, third.name}
    assert cc.cache_events() == {"hits": 0, "misses": 3}
    assert build.build(SOURCES[0]) == first  # loaded: a hit, no compile
    assert cc.cache_events(since={SOURCES[1]: 1.0, SOURCES[2]: 1.0}) == \
        {"hits": 0, "misses": 1}


def test_train_main_summary_carries_the_reference_keys(tmp_path, capsys,
                                                       monkeypatch,
                                                       fresh_build_state):
    """train_main enables the cache before its first kernel and reports
    the reference's five keys; on the CPU no kernel is built, so no hit,
    no miss and no entry."""
    from kubedl_tpu_torch.training import entry

    for name in dir(entry):
        if name.startswith("ENV_"):
            monkeypatch.delenv(getattr(entry, name), raising=False)
    cfg = {"model": "tiny", "steps": 1, "seq_len": 32, "global_batch": 2,
           "device": "cpu"}
    cache = tmp_path / "cache"
    assert entry.train_main({"KUBEDL_TRAIN_CONFIG": json.dumps(cfg),
                             "KUBEDL_COMPILE_CACHE_DIR": str(cache)}) == 0
    summary = json.loads([ln for ln in capsys.readouterr().out.splitlines()
                          if ln.startswith('{"worker_summary"')][-1]
                         )["worker_summary"]
    assert summary["compile_cache"] == {
        "dir": str(cache.resolve()), "entries_before": 0,
        "entries_after": 0, "cache_hits": 0, "cache_misses": 0}
    assert build.build_dir() == cache.resolve()
