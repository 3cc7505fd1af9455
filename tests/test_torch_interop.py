"""State carried between the JAX package and the port, the port's device
rule, and its import rule.

A JAX factorization, passed as numpy arrays keyed by field name, is
replayed by the port's ``caqr_apply_qt`` and gives [R; 0]; the port's own
factorization round-trips through the same dict. Without CUDA, an entry
point that makes tensors from numpy raises unless asked for the CPU.
"""
import ast
import pathlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro_torch import interop

ROOT = pathlib.Path(__file__).resolve().parent.parent


def jax_arrays(res):
    out = {"R": np.asarray(res.R)}
    for group in (res.factors, res.bundles):
        if group is not None:
            out.update({f: np.asarray(x) for f, x in zip(group._fields, group)})
    return out


@pytest.mark.parametrize("P,m_loc,n,b", [(4, 8, 16, 4), (4, 6, 10, 4)])
def test_jax_factorization_replayed_by_port_gives_R(rng, P, m_loc, n, b):
    A = rng.standard_normal((P, m_loc, n)).astype(np.float32)
    jres = J.caqr_factorize(jnp.asarray(A), J.SimComm(P), b, use_scan=False,
                            collect_bundles=True)
    res = interop.result_from_arrays(jax_arrays(jres), device="cpu")
    assert res.bundles is not None
    QtA = T.caqr_apply_qt(interop.to_tensor(A, device="cpu"), res.factors,
                          T.SimComm(P)).numpy()
    geom = T.sweep_geometry(P, m_loc, n, b)
    flat = QtA.reshape(-1, QtA.shape[-1])[:, :n]
    R = np.asarray(jres.R[0])
    scale = max(1.0, np.abs(R).max())
    np.testing.assert_allclose(flat[:geom.k], R, atol=3e-4 * scale)
    assert np.abs(flat[geom.k:]).max() <= 3e-4 * scale


def test_port_result_round_trips_through_arrays(rng):
    P, m_loc, n, b = 4, 8, 12, 4
    A = rng.standard_normal((P, m_loc, n)).astype(np.float32)
    res = T.caqr_factorize(interop.to_tensor(A, device="cpu"), T.SimComm(P), b,
                           use_scan=False, collect_bundles=True)
    arrays = interop.result_to_arrays(res)
    back = interop.result_from_arrays(arrays, device="cpu")
    for x, y in zip(res.factors + res.bundles + (res.R,),
                    back.factors + back.bundles + (back.R,)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    jres = J.caqr_factorize(jnp.asarray(A), J.SimComm(P), b, use_scan=False,
                            collect_bundles=True)
    want = jax_arrays(jres)
    assert set(arrays) == set(want)
    for k, v in want.items():
        assert arrays[k].dtype == v.dtype and arrays[k].shape == v.shape, k
    # the JAX package replays the port's factors too
    jf = J.PanelFactors(*(jnp.asarray(arrays[f]) for f in J.PanelFactors._fields))
    QtA = np.asarray(J.caqr_apply_qt(jnp.asarray(A), jf, J.SimComm(P)))
    R = res.R[0].numpy()
    np.testing.assert_allclose(QtA.reshape(-1, n)[:n], R,
                               atol=3e-4 * max(1.0, np.abs(R).max()))


def test_numpy_entry_points_need_cuda_unless_asked_for_cpu():
    A = np.zeros((8, 4), np.float32)
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the rule is about machines without")
    for call in (lambda: T.block_row_layout(A, 4),
                 lambda: interop.to_tensor(A),
                 lambda: interop.result_from_arrays({"R": A})):
        with pytest.raises(RuntimeError):
            call()
    assert T.block_row_layout(A, 4, device="cpu").device.type == "cpu"


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    """The port, chip_smoke.py and the card's test file run where JAX is
    not installed."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_cuda.py"]
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {mod}"
