"""The port's QR service (``repro_torch.serve.qr_service``), its batched
front end (``caqr_factorize_batched`` / ``caqr_apply_qt_batched``) and its
launcher (``repro_torch.launch.serve_qr``) against the JAX package, at the
geometry of ``tests/test_serve.py`` (P = 4, b = 4, bucket (8, 14)).

Against the JAX package: the same bucket, panels, ticks resident and
retirement tick for every request id; R (rows sign-fixed by their own
diagonals in each package: a zero-padded tenant's row signs can be set by
round-off) and the lstsq x within the f32 pair of
``repro.kernels.ref.tolerances``; the REBUILD ledgers (point, lane, reads)
exactly. Inside the port, bitwise: every retired R equals a solo
``caqr_factorize`` of the bucket-padded matrix, kill == failure-free,
``drain_batched`` == continuous, the batched entries == their per-problem
runs.

The JAX services run once per scenario in module-scoped fixtures.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import SimComm as JSimComm
from repro.core import block_row_layout as j_block_row_layout
from repro.core import caqr_apply_qt_batched as j_apply_qt_batched
from repro.core import caqr_factorize_batched as j_factorize_batched
from repro.kernels.ref import tolerances
from repro.serve.qr_service import QRService as JQRService
from repro_torch.core import (
    SimComm,
    block_row_layout,
    caqr_apply_qt,
    caqr_apply_qt_batched,
    caqr_factorize,
    caqr_factorize_batched,
)
from repro_torch.ft.online.orchestrator import compiled_segment
from repro_torch.launch import serve_qr
from repro_torch.serve import QRService

RTOL, ATOL = tolerances(np.float32)
P = 4
B_PANEL = 4
BUCKET = (8, 14)  # (m_loc, n_bucket): fits m <= 32, n + nrhs <= 14
SHAPES = [(10, 6), (16, 12), (7, 10), (24, 9), (12, 12)]
# scenario -> (max_slots, kill lane after the second tick or None, the
# number of requests submitted before the first tick)
SCENARIOS = {
    "admission": (2, None, 3),   # slot pressure: FIFO queue, staggered
    "full": (8, None, 5),        # every tenant resident at once
    "kill": (4, 2, 5),           # lane 2 killed under load
}


def _requests():
    """test_serve.py's traffic: five ragged tenants, the first with two
    rhs columns."""
    rng = np.random.default_rng(0)
    out = []
    for i, (m, n) in enumerate(SHAPES):
        A = rng.standard_normal((m, n)).astype(np.float32)
        rhs = (rng.standard_normal((m, 2)).astype(np.float32)
               if i == 0 else None)
        out.append((A, rhs))
    return out


REQS = _requests()


def _drive(svc, scenario):
    """Run a scenario to the end; returns (results, {rid: retire tick})."""
    slots, kill, first = SCENARIOS[scenario]
    for A, rhs in REQS[:first]:
        svc.submit(A, rhs)
    retired_at = {}

    def tick():
        for r in svc.tick():
            retired_at[r.rid] = svc.tick_count - 1

    tick()
    for A, rhs in REQS[first:]:
        svc.submit(A, rhs)
    if kill is not None:
        tick()
        svc.kill_lane(kill)
    while svc.queue or svc.resident:
        tick()
    return svc.results, retired_at


def _port(scenario):
    slots = SCENARIOS[scenario][0]
    return QRService(SimComm(P), panel_width=B_PANEL, buckets=[BUCKET],
                     max_slots=slots, device="cpu")


def _jax(scenario):
    slots = SCENARIOS[scenario][0]
    return JQRService(JSimComm(P), panel_width=B_PANEL, buckets=[BUCKET],
                      max_slots=slots)


@pytest.fixture(scope="module")
def jax_runs():
    return {sc: _drive(_jax(sc), sc) for sc in SCENARIOS}


@pytest.fixture(scope="module")
def port_runs():
    return {sc: _drive(_port(sc), sc) for sc in SCENARIOS}


@pytest.fixture(scope="module")
def jax_drained():
    svc = _jax("full")
    for A, rhs in REQS:
        svc.submit(A, rhs)
    return svc.drain_batched()


@pytest.fixture(scope="module")
def port_drained():
    svc = _port("full")
    for A, rhs in REQS:
        svc.submit(A, rhs)
    return svc.drain_batched()


def _signfix(R):
    R = np.asarray(R)
    s = np.sign(np.diag(R))
    s[s == 0] = 1.0
    return R * s[:, None]


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=ATOL * max(1.0, np.abs(want).max()))


def _solo_R(A, rhs):
    """The acceptance oracle: a failure-free solo factorization of the
    tenant's bucket-padded (rhs-augmented) matrix, sliced to its shape."""
    A_aug = A if rhs is None else np.concatenate([A, rhs], axis=1)
    A0 = block_row_layout(A_aug, P, *BUCKET, device="cpu")
    res = caqr_factorize(A0, SimComm(P), B_PANEL, use_scan=False,
                         collect_bundles=True)
    k, n = min(A.shape), A.shape[1]
    return res.R[0, :k, :n].numpy()


def _ledger(events):
    return [(tuple(e.point), e.lane, dict(e.reads)) for e in events]


# -- the service against the JAX package -----------------------------------


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_schedule_matches_jax(jax_runs, port_runs, scenario):
    """Same bucket, panels, ticks resident and retirement tick for every
    request id: the admission, early-retirement and FIFO policy agree."""
    (jres, jticks), (tres, tticks) = jax_runs[scenario], port_runs[scenario]
    assert sorted(tres) == sorted(jres) == [f"req{i}" for i in range(5)]
    assert tticks == jticks
    for rid in jres:
        j, t = jres[rid], tres[rid]
        assert (t.bucket, t.panels, t.ticks_resident) == (
            tuple(j.bucket), j.panels, j.ticks_resident), rid
        assert t.panels == -(-min(t.R.shape) // B_PANEL)


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_results_match_jax(jax_runs, port_runs, scenario):
    """R (rows sign-fixed in each package) and x within tolerance."""
    jres, tres = jax_runs[scenario][0], port_runs[scenario][0]
    for rid in jres:
        j, t = jres[rid], tres[rid]
        assert t.R.shape == np.asarray(j.R).shape and t.R.dtype == np.float32
        _close(_signfix(t.R), _signfix(j.R))
        assert (t.x is None) == (j.x is None), rid
        if t.x is not None:
            _close(t.x, j.x)


def test_kill_ledgers_match_jax(jax_runs, port_runs):
    """After kill_lane, every tenant's REBUILD ledger (point, lane, reads)
    equals JAX's, and every tenant resident at the kill was healed."""
    jres, tres = jax_runs["kill"][0], port_runs["kill"][0]
    for rid in jres:
        assert _ledger(tres[rid].events) == _ledger(jres[rid].events), rid
        assert all(e.lane == 2 and e.sources for e in tres[rid].events)
    # four slots: req0-req3 were resident at the kill, req4 was queued
    healed = {rid: len(r.events) for rid, r in tres.items()}
    assert healed == {"req0": 1, "req1": 1, "req2": 1, "req3": 1, "req4": 0}


def test_drain_batched_matches_jax(jax_drained, port_drained):
    assert sorted(port_drained) == sorted(jax_drained)
    for rid, j in jax_drained.items():
        t = port_drained[rid]
        assert (t.bucket, t.panels, t.ticks_resident, t.events) == (
            tuple(j.bucket), j.panels, j.ticks_resident, [])
        _close(_signfix(t.R), _signfix(j.R))
        if j.x is not None:
            _close(t.x, j.x)


def test_lstsq_matches_numpy_and_jax():
    """The rhs rides the bucket: retirement back-solves numpy's dense
    lstsq answer, and JAX's."""
    rng = np.random.default_rng(1)
    A = rng.standard_normal((20, 8)).astype(np.float32)
    rhs = rng.standard_normal((20, 2)).astype(np.float32)
    x_ref, *_ = np.linalg.lstsq(A.astype(np.float64),
                                rhs.astype(np.float64), rcond=None)
    xs = []
    for svc in (_port("admission"), _jax("admission")):
        rid = svc.submit(A, rhs)
        xs.append(np.asarray(svc.run_until_drained()[rid].x))
    np.testing.assert_allclose(xs[0], x_ref, atol=1e-3)
    _close(xs[0], xs[1])


@pytest.mark.parametrize("m,n_total", [(10, 6), (32, 14), (33, 4), (8, 15),
                                        (17, 3)])
def test_select_bucket_matches_jax(m, n_total):
    """Buckets sorted by area, the smallest that fits; a misfit raises in
    both packages."""
    buckets = [(16, 8), (4, 6), (8, 14)]
    t = QRService(SimComm(P), panel_width=B_PANEL, buckets=buckets,
                  device="cpu")
    j = JQRService(JSimComm(P), panel_width=B_PANEL, buckets=buckets)
    assert t.buckets == [tuple(bk) for bk in j.buckets]
    try:
        want = j.select_bucket(m, n_total)
    except ValueError:
        with pytest.raises(ValueError):
            t.select_bucket(m, n_total)
    else:
        assert t.select_bucket(m, n_total) == want


# -- the batched front end against the JAX package --------------------------


@pytest.mark.parametrize("use_scan,m_loc,n", [(True, 8, 14), (False, 8, 14),
                                              (False, 6, 10)])
def test_batched_front_end_matches_jax(use_scan, m_loc, n):
    """caqr_factorize_batched (R, factors, bundles) and
    caqr_apply_qt_batched against the JAX package's vmapped entries."""
    rng = np.random.default_rng(2)
    A = rng.standard_normal((3, P, m_loc, n)).astype(np.float32)
    jcomm = JSimComm(P)
    jres = j_factorize_batched(jnp.asarray(A), jcomm, B_PANEL,
                               use_scan=use_scan, collect_bundles=True)
    tres = caqr_factorize_batched(torch.from_numpy(A), SimComm(P), B_PANEL,
                                  use_scan=use_scan, collect_bundles=True)
    _close(tres.R.numpy(), jres.R)
    for got, want in zip((*tres.factors, *tres.bundles),
                         (*jres.factors, *jres.bundles)):
        assert tuple(got.shape) == tuple(want.shape)
        if got.is_floating_point():
            _close(got.numpy(), want)
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    Bm = rng.standard_normal((3, P, m_loc, 5)).astype(np.float32)
    _close(caqr_apply_qt_batched(torch.from_numpy(Bm), tres.factors,
                                 SimComm(P)).numpy(),
           j_apply_qt_batched(jnp.asarray(Bm), jres.factors, jcomm))


def test_block_row_layout_matches_jax():
    A, rhs = REQS[0]
    A_aug = np.concatenate([A, rhs], axis=1)
    np.testing.assert_array_equal(
        block_row_layout(A_aug, P, *BUCKET, device="cpu").numpy(),
        np.asarray(j_block_row_layout(jnp.asarray(A_aug), P, *BUCKET)))


# -- the port's own bitwise contracts ---------------------------------------


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_retired_R_equals_solo_bitwise(port_runs, scenario):
    """Whether a tenant drained alone, queued, joined mid-stream or
    survived a kill, its R is the solo factorization's bits."""
    res = port_runs[scenario][0]
    for i, (A, rhs) in enumerate(REQS):
        np.testing.assert_array_equal(res[f"req{i}"].R, _solo_R(A, rhs))


def test_kill_equals_failure_free_bitwise(port_runs):
    killed, clean = port_runs["kill"][0], port_runs["full"][0]
    assert sum(len(r.events) for r in killed.values()) >= 1
    for rid, r in clean.items():
        np.testing.assert_array_equal(killed[rid].R, r.R)
        if r.x is not None:
            np.testing.assert_array_equal(killed[rid].x, r.x)


def test_drain_batched_equals_continuous_bitwise(port_runs, port_drained):
    clean = port_runs["full"][0]
    assert sorted(port_drained) == sorted(clean)
    for rid, r in clean.items():
        np.testing.assert_array_equal(port_drained[rid].R, r.R)
        assert (port_drained[rid].x is None) == (r.x is None)
        if r.x is not None:
            np.testing.assert_array_equal(port_drained[rid].x, r.x)


@pytest.mark.parametrize("use_scan", [True, False])
def test_batched_equals_solo_bitwise(use_scan):
    """Every field of the batched result is the stack of the per-problem
    runs' bits, and so is the batched Q^T replay."""
    rng = np.random.default_rng(3)
    comm = SimComm(P)
    A = torch.from_numpy(rng.standard_normal((3, P, 6, 10)).astype(np.float32))
    res = caqr_factorize_batched(A, comm, B_PANEL, use_scan=use_scan,
                                 collect_bundles=True)
    QtA = caqr_apply_qt_batched(A, res.factors, comm)
    for i in range(3):
        one = caqr_factorize(A[i], comm, B_PANEL, use_scan=use_scan,
                             collect_bundles=True)
        for got, want in zip((res.R[i], *(x[i] for x in res.factors),
                              *(x[i] for x in res.bundles)),
                             (one.R, *one.factors, *one.bundles)):
            assert got.dtype == want.dtype and torch.equal(got, want)
        assert torch.equal(QtA[i], caqr_apply_qt(A[i], one.factors, comm))
    without = caqr_factorize_batched(A, comm, B_PANEL, use_scan=use_scan)
    assert without.bundles is None and torch.equal(without.R, res.R)


def test_no_new_runners_at_steady_state():
    """One segment runner serves every bucket: the process-wide
    ``compiled_segment`` of (comm kind, P, points), shared with any other
    service. ``compiled_programs`` mirrors the reference's count, 0 before
    a segment has run and 1 after, whatever the traffic."""
    svc = QRService(SimComm(P), panel_width=B_PANEL,
                    buckets=[BUCKET, (4, 6)], max_slots=3, device="cpu")
    other = QRService(SimComm(P), panel_width=B_PANEL, buckets=[(16, 20)],
                      max_slots=1, device="cpu")
    assert svc._segment is other._segment
    assert svc._segment is compiled_segment(SimComm(P), 1 + 2 * 2)
    for A, rhs in REQS[:3]:
        svc.submit(A, rhs)
    svc.tick()  # admits: no segment has run yet
    assert svc.compiled_programs == 0
    svc.tick()
    warm = svc.compiled_programs
    assert warm == 1
    svc.run_until_drained()
    for A, rhs in REQS:  # second wave, staggered
        svc.submit(A, rhs)
        svc.tick()
    svc.submit(np.ones((5, 3), np.float32))  # the small bucket
    svc.run_until_drained()
    assert {r.bucket for r in svc.results.values()} == {BUCKET, (4, 6)}
    assert svc.compiled_programs == warm


def test_service_state_lives_on_its_device(monkeypatch):
    """Tenant states live on the service's device; the default device is
    CUDA, and without a GPU it raises instead of falling back."""
    svc = _port("full")
    svc.submit(*REQS[1])
    svc.tick()
    (slot,) = [s for s in svc.slots if s is not None]
    assert slot.state.A.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        QRService(SimComm(P), panel_width=B_PANEL, buckets=[BUCKET])


# -- the launcher -----------------------------------------------------------


def test_serve_qr_main_cpu_with_kill(capsys):
    """``python -m repro_torch.launch.serve_qr --device cpu --kill-lane 1``
    at its defaults serves, heals and verifies every tenant."""
    serve_qr.main(["--device", "cpu", "--kill-lane", "1"])
    out = capsys.readouterr().out
    assert "served 12 requests on cpu" in out
    assert "1 resident segment runners" in out
    assert "0 tenant REBUILDs" not in out
    assert "all results verified against numpy QR/lstsq" in out


def test_serve_qr_verify_rejects_a_wrong_R():
    rng = np.random.default_rng(4)
    (A, rhs), = serve_qr.make_requests(rng, 1, 4, 24, 12, 0.0)
    svc = _port("full")
    rid = svc.submit(A, rhs)
    res = svc.run_until_drained()[rid]
    serve_qr.verify(res, A, rhs)
    res.R[0, -1] += 1.0
    with pytest.raises(AssertionError, match="R mismatch"):
        serve_qr.verify(res, A, rhs)
