"""The port's autotuner (``repro_torch.kernels.autotune``) against the JAX
package's, on the CPU: the cell keys are the reference's, the cache file
is the reference's format, a cache the JAX package wrote is kept and never
adopted, and tuning on the CPU (the plain version, no knob) returns None.
The card's side (every candidate bit-equal, a planted winner reaching the
launch) is in ``tests/test_torch_cuda.py``.
"""
import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import autotune as j_autotune
from repro_torch.kernels import autotune, backend, build, ops, wide


@pytest.fixture(autouse=True)
def _clean_tuners(monkeypatch):
    monkeypatch.delenv(autotune.CACHE_ENV, raising=False)
    autotune.clear()
    j_autotune.clear()
    yield
    autotune.clear()
    j_autotune.clear()


@pytest.mark.parametrize("op,geometry,jdt,tdt,variant", [
    ("wy_apply", (8, 4096, 128, 4096), jnp.float32, torch.float32, "cuda"),
    ("stacked_apply", (8, 256, 4096), np.float32, np.float32, "cuda"),
    ("panel_qr", (256, 64), jnp.bfloat16, torch.bfloat16, "interpret"),
])
def test_cell_key_is_the_reference_key(op, geometry, jdt, tdt, variant):
    assert autotune.cell_key(op, geometry, tdt, variant) == \
        j_autotune.cell_key(op, geometry, jdt, variant)


def test_candidates():
    tiles = [{}] + [{"bn": bn} for bn in backend.TILE_BNS]
    assert autotune.candidates("wy_apply", "cuda", (8, 4096, 128, 4096)) == tiles
    assert autotune.candidates("stacked_apply", "cuda", (8, 128, 4096)) == tiles
    # above 128: the products' tile and k range; K2's longest sum is over m
    # (16 block sums at 4096), K4's over b (one block sum at 256)
    wide2 = autotune.candidates("wy_apply", "cuda", (8, 4096, 256, 4096))
    assert wide2[0] == {} and len(wide2) == 1 + len(wide.TILES) * 4
    assert {c["kbs"] for c in wide2[1:]} == {16, 8, 4, 2}
    assert {c["bn"] for c in wide2[1:]} == set(wide.TILES)
    wide4 = autotune.candidates("stacked_apply", "cuda", (8, 256, 4096))
    assert wide4 == [{}] + [{"bn": bn, "kbs": 1} for bn in wide.TILES]
    # nothing to tune: K1 and K3 (team size fixed by (m, b)), K5 and K6, and
    # the plain version
    for op in ("panel_qr", "stacked_qr", "panel_qr_apply", "fused_panel"):
        assert autotune.candidates(op, "cuda") == [{}]
    assert autotune.candidates("wy_apply", "plain", (8, 64, 16, 64)) == [{}]


def test_tune_on_the_cpu_returns_none():
    assert autotune.tune("wy_apply", (2, 64, 16, 32), device="cpu") is None
    assert autotune.tune_all(device="cpu") == {}
    assert autotune.current_variant("wy_apply", "cpu") == "plain"
    assert autotune._CELLS == {}


def test_fingerprint_names_the_build():
    fp = backend.backend_fingerprint()
    assert fp.startswith("cpu:") and fp.endswith(f"src-{build.sources_digest()}")
    assert fp == backend.backend_fingerprint()


def test_fingerprint_changes_with_the_sources(tmp_path, monkeypatch):
    real = build.sources_digest()
    for p in build.CSRC.iterdir():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    build.sources_digest.cache_clear()
    try:
        monkeypatch.setattr(build, "CSRC", tmp_path)
        same = build.sources_digest()
        build.sources_digest.cache_clear()
        (tmp_path / "wide.cu").write_bytes(b"// one more line\n"
                                           + (tmp_path / "wide.cu").read_bytes())
        changed = build.sources_digest()
    finally:
        build.sources_digest.cache_clear()
    assert same == real
    assert changed != same


def test_save_load_round_trip(tmp_path):
    key = autotune.cell_key("wy_apply", (8, 4096, 128, 4096), torch.float32, "cuda")
    rec = {"params": {"bn": 64}, "us": 1812.4, "static_us": 1865.0}
    autotune._CELLS[key] = rec
    path = autotune.save(str(tmp_path / "cache.json"))
    payload = json.loads(open(path).read())
    assert payload == {"version": 1,
                       "cells": {backend.backend_fingerprint(): {key: rec}}}
    autotune.clear()
    assert autotune.lookup("wy_apply", (8, 4096, 128, 4096), torch.float32) == {}
    assert autotune.load(path) == 1
    assert autotune.lookup("wy_apply", (8, 4096, 128, 4096), torch.float32) == {"bn": 64}
    assert autotune.lookup("wy_apply", (8, 4096, 128, 512), torch.float32) == {}


def test_a_cache_of_the_jax_package_is_kept_and_not_adopted(tmp_path):
    j_autotune._CELLS[j_autotune.cell_key("wy_apply", (256, 64, 512), jnp.float32,
                                          "interpret")] = {"params": {"block_n": 128},
                                                           "us": 812.4}
    jpath = j_autotune.save(str(tmp_path / "jax.json"))
    jcells = json.loads(open(jpath).read())["cells"]
    assert backend.backend_fingerprint() not in jcells
    assert autotune.load(jpath) == 0
    assert autotune.lookup("wy_apply", (256, 64, 512), torch.float32, "interpret") == {}
    key = autotune.cell_key("stacked_apply", (8, 128, 4096), torch.float32, "cuda")
    autotune._CELLS[key] = {"params": {"bn": 32}, "us": 90.0, "static_us": 99.0}
    out = json.loads(open(autotune.save(str(tmp_path / "both.json"))).read())
    assert set(out["cells"]) == set(jcells) | {backend.backend_fingerprint()}
    for fp, cells in jcells.items():
        assert out["cells"][fp] == cells
    # and the JAX package, reading the port's file, keeps the port's cells
    j_autotune.clear()
    assert j_autotune.load(str(tmp_path / "both.json")) == len(next(iter(jcells.values())))


def test_cache_env_loads_at_the_first_lookup(tmp_path, monkeypatch):
    key = autotune.cell_key("wy_apply", (2, 64, 16, 32), torch.float32, "cuda")
    path = tmp_path / "env.json"
    path.write_text(json.dumps({"version": 1, "cells": {
        backend.backend_fingerprint(): {key: {"params": {"bn": 32}, "us": 1.0}}}}))
    monkeypatch.setenv(autotune.CACHE_ENV, str(path))
    monkeypatch.setattr(autotune, "_ENV_LOADED", False)
    assert autotune.lookup("wy_apply", (2, 64, 16, 32), torch.float32) == {"bn": 32}
    assert autotune.save() == str(path)


def test_meta_tensors_take_the_plain_version_shape_only():
    """The dry run's route: meta tensors through ``ops`` give the plain
    version's shapes, count no launch and report no engine."""
    backend.reset_launches()
    before = dict(backend._LAST_ENGINE)
    P, m, b, n = 4, 64, 16, 40
    meta = lambda *s: torch.empty(*s, device="meta")  # noqa: E731
    Y, T, R = ops.panel_qr(meta(P, m, b), 0)
    assert (Y.shape, T.shape, R.shape) == ((P, m, b), (P, b, b), (P, b, b))
    assert Y.device.type == "meta"
    assert ops.wy_apply(meta(P, m, b), meta(P, b, b), meta(P, m, n)).shape == (P, m, n)
    outs = ops.stacked_apply(meta(P, b, b), meta(P, b, b), meta(P, b, n), meta(P, b, n))
    assert [o.shape for o in outs] == [(P, b, n)] * 3
    assert all(v == 0 for v in backend.LAUNCHES.values())
    assert backend._LAST_ENGINE == before
