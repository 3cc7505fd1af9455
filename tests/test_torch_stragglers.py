"""The port's straggler monitor (``repro_torch.ft.stragglers``) against the
JAX package's ``repro.ft.stragglers``: the same per-lane times from a
seed give the same flagged lanes, the same EWMAs and shares after a
``rebalance``, and the same ``lane_rows``, exactly (both are numpy and
Python floats in the same order of operations).
"""
import numpy as np
import pytest

from repro.ft import stragglers as jstr
from repro_torch.ft import stragglers as tstr


def _monitors(n, **cfg):
    return (tstr.StragglerMonitor(n, tstr.StragglerConfig(**cfg)),
            jstr.StragglerMonitor(n, jstr.StragglerConfig(**cfg)))


def _times(rng, n, steps, slow):
    """Per-step lane times: noise around 1.0, lanes in ``slow`` about 3x."""
    for _ in range(steps):
        t = 1.0 + 0.1 * rng.standard_normal(n)
        for lane in slow:
            t[lane] *= 3.0
        yield {i: float(x) for i, x in enumerate(t)}


def test_enums_and_config_defaults_match():
    assert [p.value for p in tstr.StragglerPolicy] == \
        [p.value for p in jstr.StragglerPolicy]
    t, j = tstr.StragglerConfig(), jstr.StragglerConfig()
    assert (t.threshold, t.patience, t.ewma, t.min_share, t.policy.value,
            t.escalate_after) == (j.threshold, j.patience, j.ewma,
                                  j.min_share, j.policy.value,
                                  j.escalate_after)
    assert tstr.SpeculationEvent._fields == jstr.SpeculationEvent._fields


@pytest.mark.parametrize("n,slow,cfg", [
    (4, [2], dict(threshold=1.4, patience=2)),
    (8, [1, 6], dict(threshold=1.5, patience=3, ewma=0.3)),
    (8, [], dict()),
    (16, [0, 5, 9], dict(threshold=1.2, patience=1, min_share=0.4)),
])
def test_decisions_rebalance_and_rows_equal_reference(n, slow, cfg):
    tm, jm = _monitors(n, **cfg)
    rng = np.random.default_rng(n + len(slow))
    acted = []
    for step in _times(rng, n, 12, slow):
        got, want = tm.report(step), jm.report(step)
        assert got == want
        assert tm.ewma == jm.ewma and tm.flags == jm.flags
        for lane in got:
            acted.append(lane)
            assert tm.rebalance(lane) == jm.rebalance(lane)
        for batch in (64, 1000, 4097):
            assert tm.lane_rows(batch) == jm.lane_rows(batch)
            assert sum(tm.lane_rows(batch).values()) == batch
    assert set(acted) <= set(slow)
    if slow and cfg.get("patience", 3) <= 3:
        assert acted, "a persistent straggler was never flagged"


def test_no_false_positive_on_uniform_lanes():
    tm, jm = _monitors(4)
    for _ in range(10):
        times = {i: 1.0 for i in range(4)}
        assert tm.report(times) == jm.report(times) == []
    assert tm.lane_rows(100) == jm.lane_rows(100) == {i: 25 for i in range(4)}
