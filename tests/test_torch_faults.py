# The port's fault injection (spark_rapids_ml_tpu_torch.parallel.faults)
# against the JAX package's, on the CPU: the scenarios of
# tests/test_faults.py that need no control plane, context or runner.  The
# same plan text must parse to the same specs and fire the same way in both
# modules; the unarmed site() stays a bare None check.
import time

import pytest

from spark_rapids_ml_tpu import profiling as ref_profiling
from spark_rapids_ml_tpu.parallel import faults as ref_faults

from spark_rapids_ml_tpu_torch.parallel import faults as port_faults

MODS = {"jax": ref_faults, "port": port_faults}


@pytest.fixture
def armed(monkeypatch):
    """armed(spec): SRML_FAULTS for both modules, arrival counters reset;
    disarmed after the test."""

    def arm(spec):
        monkeypatch.setenv(port_faults.FAULTS_ENV, spec)
        ref_faults.reload()
        port_faults.reload()

    yield arm
    monkeypatch.delenv(port_faults.FAULTS_ENV, raising=False)
    ref_faults.reload()
    port_faults.reload()


def _specs(plan):
    return None if plan is None else [(s.site, s.action, s.rank, s.call, s.tag, s.delay_s) for s in plan.specs]


@pytest.mark.parametrize("text", [
    "cp.gather:rank=1:call=2:action=die",
    "cp.barrier:rank=0:delay=2.5;serving.dispatch:tag=km:action=kill;exchange.ring_pass:action=corrupt",
    "serving.dispatch:tag=a-r0:call=3:action=kill",
    "cp.net.send:rank=1:call=5:action=partition",
    "cp.net.recv:action=drop",
    "my.new.site:action=raise",
    None,
    "  ",
])
def test_plan_grammar_matches_jax(text):
    assert _specs(port_faults.parse_plan(text)) == _specs(ref_faults.parse_plan(text))


@pytest.mark.parametrize("text,message", [
    ("cp.gather:action=explode", "unknown action"),
    ("cp.gather:rank=1", "no action"),
    ("cp.gather:frequency=2:action=die", "unknown field"),
    ("cp.gather:action=delay", "delay="),
    ("cp.gather:rank", "malformed field"),
    ("cp.gather:action=drop", "only applies to wire sites"),
])
def test_plan_grammar_is_strict_as_in_jax(text, message):
    for mod in MODS.values():
        with pytest.raises(ValueError, match=message):
            mod.parse_plan(text)


def test_site_registry_and_exit_code_match_jax():
    assert port_faults.SITES == ref_faults.SITES
    assert port_faults.DIE_EXIT_CODE == ref_faults.DIE_EXIT_CODE == 17


def test_unarmed_site_is_a_single_none_check(monkeypatch):
    assert port_faults.plan() is None and not port_faults.armed()
    loads = []
    monkeypatch.setattr(port_faults, "_load", lambda: loads.append(1))
    for _ in range(64):
        assert port_faults.site("cp.gather", rank=0, payload=b"x") == b"x"
    assert not loads

    n = 20000

    def bench(fn):
        t0 = time.perf_counter()
        for _ in range(n):
            fn("cp.gather")
        return (time.perf_counter() - t0) / n

    def empty(_name):
        return None

    added = max(min(bench(port_faults.site) for _ in range(3)) - min(bench(empty) for _ in range(3)), 0.0)
    assert added * 10_000 < 0.005, f"unarmed site() adds {added * 1e9:.0f} ns a call"


def test_armed_plan_selects_by_rank(armed):
    armed("cp.gather:rank=1:action=raise")
    for mod in MODS.values():
        assert mod.armed()
        assert mod.site("cp.gather", rank=0, payload=b"a") == b"a"
        assert mod.site("cp.gather", rank=2, payload=b"a") == b"a"
        with pytest.raises(mod.FaultInjected, match="cp.gather"):
            mod.site("cp.gather", rank=1)


def test_armed_plan_counts_arrivals_per_site_and_tag(armed):
    armed("serving.dispatch:tag=srv_a:call=2:action=raise")
    for mod in MODS.values():
        mod.site("serving.dispatch", tag="srv_b")
        mod.site("serving.dispatch", tag="srv_a")
        with pytest.raises(mod.FaultInjected, match="serving.dispatch"):
            mod.site("serving.dispatch", tag="srv_a")
        mod.site("serving.dispatch", tag="srv_a")
    assert port_faults.plan().counts() == ref_faults.plan().counts()
    assert port_faults.plan().counts()[("serving.dispatch", "srv_a")] == 3


def test_action_delay_and_corrupt(armed):
    armed("cp.barrier:delay=0.05;exchange.ring_pass:action=corrupt")
    payload = b"SRX1" + b"\x00" * 32
    out = {}
    for name, mod in MODS.items():
        t0 = time.monotonic()
        mod.site("cp.barrier", rank=0)
        assert time.monotonic() - t0 >= 0.045
        out[name] = mod.site("exchange.ring_pass", rank=0, payload=payload)
        with pytest.raises(mod.FaultInjected):
            mod.site("exchange.ring_pass", rank=0)
    assert out["port"] == out["jax"] != payload and out["port"][:4] != b"SRX1"


def test_action_kill_drop_and_partition(armed):
    armed("serving.dispatch:action=kill;cp.net.send:rank=1:call=2:action=partition;cp.net.recv:rank=0:action=drop")
    for mod in MODS.values():
        with pytest.raises(mod.InjectedWorkerDeath):
            mod.site("serving.dispatch", tag="x")
        assert not issubclass(mod.InjectedWorkerDeath, Exception)
        assert mod.site("cp.net.send", rank=1, payload=b"f") == b"f"  # call 1
        assert mod.site("cp.net.send", rank=1, payload=b"f") is mod.DROPPED  # partitioned from here on
        assert mod.site("cp.net.recv", rank=1, payload=b"f") is mod.DROPPED  # both directions
        assert mod.site("cp.net.recv", rank=0, payload=b"f") is mod.DROPPED
        assert mod.plan().partitioned() == {1}
    assert ref_profiling is not None
