"""The port's SLO outputs against ``repro``: ``RequestRecord.
deadline_met`` and the ``summary()`` keys ``deadline_met`` (per
deadline-carrying request) and ``goodput`` (the share that met its
deadline; expired and failed requests count as unmet). The two servers
run in lockstep (tests/_serving_parity.py) on a trace with deadlines,
under one injected metrics clock that reads the step number, so
admission-time expiry and completion times are the same in both."""
import pytest

torch = pytest.importorskip("torch")

from _serving_parity import (build_pair, lockstep, one_torch_thread,  # noqa: E402
                             same_metrics, same_tokens, servers,
                             shared_prefix_trace)
from repro_torch.serving.metrics import RequestRecord, ServingMetrics  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def pair():
    return build_pair()


# rid -> absolute deadline in steps (None: best effort)
DEADLINES = [None, 60.0, 1.5, 1.5, 1.5, 1.5, 1.5, 25.0]


@pytest.mark.parametrize("gamma", [3, 0])
def test_deadline_outcomes_match_jax_in_lockstep(pair, gamma):
    t = [0.0]
    port, ref = servers(pair, gamma, now=lambda: t[0])

    def tick(k, _):
        t[0] = k + 1.0
        return ()
    reqs = shared_prefix_trace(seed=5, n=len(DEADLINES))
    _, got, want = lockstep(port, ref, reqs, tick, deadlines=DEADLINES)
    same_tokens(got, want)
    same_metrics(port, ref)
    s = port.metrics.summary()
    met = s["deadline_met"]
    assert set(met) == {i for i, d in enumerate(DEADLINES) if d is not None}
    assert s["requests_expired"] > 0
    assert True in met.values() and False in met.values()
    assert s["goodput"] == sum(met.values()) / len(met)


def test_deadline_met_property():
    m = ServingMetrics(now=lambda: 5.0)
    assert RequestRecord(0, 4, 4).deadline_met is None
    m.submit(1, 4, 4, deadline=6.0)
    m.submit(2, 4, 4, deadline=4.0)
    m.submit(3, 4, 4, deadline=9.0)
    m.submit(4, 4, 4, deadline=9.0)
    assert m.complete(1).deadline_met is True
    assert m.complete(2).deadline_met is False
    assert m.cancel(3).deadline_met is False
    m.fail(4, "guard")
    s = m.summary()
    assert s["deadline_met"] == {1: True, 2: False, 4: False}
    assert s["goodput"] == pytest.approx(1 / 3)
    assert ServingMetrics().summary()["goodput"] is None
