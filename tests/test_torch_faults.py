"""The port's fault injection (``repro_torch.core.faults``) against the JAX
package's ``repro.core.faults``, on the CPU.

The same rules and seed fire the same pattern in both packages (the same
per-rule ``random.Random(f"{seed}:{site}:{i}")``); ``every``, ``match`` and
``max_fires`` count alike; ``uninstall`` releases hung sites; one plan is
installed at a time; and the port's instrumented sites (``plan_spgemm`` in
the planner, ``device_lift`` in the torch stream's lift) fire with the
reference's keys, the device backend being ``"torch"`` where the
reference's is ``"jax"``.  Every wait has a timeout.
"""

import threading
import time

import pytest

torch = pytest.importorskip("torch")

from repro.core import faults as ref_faults
from repro_torch.core import InjectedFault, cached_plan, faults, \
    plan_cache_clear
from repro_torch.core.device_stream import device_stream
from repro_torch.sparse import random_density_csc


@pytest.fixture(autouse=True)
def no_fault_plan():
    plan_cache_clear()
    yield
    faults.uninstall()
    ref_faults.uninstall()
    plan_cache_clear()


def fire_pattern(mod, rules, site, key, n=48, seed=0):
    """Which of ``n`` checks at ``site`` fired under ``rules``."""
    plan = mod.FaultPlan([mod.FaultRule(**r) for r in rules], seed=seed)
    pattern = []
    for _ in range(n):
        try:
            plan.check(site, key=key)
            pattern.append(0)
        except mod.InjectedFault:
            pattern.append(1)
    return pattern, plan.describe()


RULE_SETS = [
    [dict(site="plan_spgemm", mode="fail", rate=0.5)],
    [dict(site="plan_spgemm", mode="fail", rate=0.2),
     dict(site="plan_spgemm", mode="fail", rate=0.3, max_fires=4)],
    [dict(site="device_lift", mode="fail", every=3, max_fires=5)],
    [dict(site="builder_worker", mode="fail", rate=0.7, match="torch")],
]


@pytest.mark.parametrize("seed", [0, 7, 11])
@pytest.mark.parametrize("rules", RULE_SETS, ids=range(len(RULE_SETS)))
def test_same_pattern_and_counters_as_the_reference(rules, seed):
    """One seed, the same fires and the same ``describe()`` (calls, fires)
    in both packages; the port's key names its backend ``"torch"``, the
    reference's ``"jax"``, so a ``match="torch"`` rule is given the
    reference's rule with ``match="jax"``."""
    site = rules[0]["site"]
    ref_rules = [dict(r, match="jax") if r.get("match") == "torch" else r
                 for r in rules]
    got, got_desc = fire_pattern(faults, rules, site, ("torch", "expand"),
                                 seed=seed)
    want, want_desc = fire_pattern(ref_faults, ref_rules, site,
                                   ("jax", "expand"), seed=seed)
    assert got == want
    assert 0 < sum(got) < len(got)
    for g, w in zip(got_desc["rules"], want_desc["rules"]):
        assert dict(g, match=None) == dict(w, match=None)


def test_rate_faults_replay_and_are_seed_sensitive():
    rules = [dict(site="plan_spgemm", mode="fail", rate=0.5)]
    p7, _ = fire_pattern(faults, rules, "plan_spgemm", "k", seed=7)
    assert p7 == fire_pattern(faults, rules, "plan_spgemm", "k", seed=7)[0]
    assert p7 != fire_pattern(faults, rules, "plan_spgemm", "k", seed=8)[0]


def test_every_fires_on_exact_calls():
    with faults.inject(faults.FaultRule("plan_spgemm", "fail", every=3,
                                        max_fires=2)) as fp:
        hits = []
        for i in range(1, 10):
            try:
                faults.check("plan_spgemm", key="k")
            except InjectedFault:
                hits.append(i)
        assert hits == [3, 6]
        assert fp.fired("plan_spgemm") == 2


def test_match_scopes_by_key():
    """``match="torch"`` never touches the host backend's calls: faults
    can target background device builds while the foreground fallback
    stays clean."""
    with faults.inject(faults.FaultRule("plan_spgemm", "fail", every=1,
                                        match="torch")):
        faults.check("plan_spgemm", key=("host", "expand"))
        with pytest.raises(InjectedFault):
            faults.check("plan_spgemm", key=("torch", "expand"))


def test_planner_site_keys_on_backend_and_method():
    """``plan_spgemm`` fires at the top of the planner with key
    ``(backend, method)``: a torch build fails, a host one of the same
    operands does not."""
    a = random_density_csc(24, 24, 0.2, seed=0)
    with faults.inject(faults.FaultRule("plan_spgemm", "fail", every=1,
                                        match="torch")) as fp:
        cached_plan(a, a, "expand", backend="host")
        with pytest.raises(InjectedFault, match="torch"):
            cached_plan(a, a, "expand", backend="torch", device="cpu")
        assert fp.fired("plan_spgemm") == 1
        assert fp.describe()["rules"][0]["calls"] == 1


def test_device_lift_site_fires_once_a_plan():
    """``device_lift`` fires where the torch stream lifts, keyed by the
    plan's backend; a failed lift leaves nothing on the plan, and the next
    call lifts."""
    a = random_density_csc(24, 24, 0.2, seed=1)
    plan = cached_plan(a, a, "expand", backend="torch", device="cpu")
    with faults.inject(faults.FaultRule("device_lift", "fail", every=1,
                                        max_fires=1, match="torch")) as fp:
        with pytest.raises(InjectedFault):
            device_stream(plan)
        assert plan.device_stream_nbytes == 0
        assert device_stream(plan) is device_stream(plan)
        assert fp.describe()["rules"][0]["calls"] == 2   # lifted once after


def test_uninstall_releases_hangs():
    with faults.inject(faults.FaultRule("builder_worker", "hang",
                                        every=1, seconds=60)):
        t0 = time.monotonic()
        done = threading.Event()

        def hang_then_done():
            faults.check("builder_worker", key="x")
            done.set()

        threading.Thread(target=hang_then_done, daemon=True).start()
        time.sleep(0.05)
        assert not done.is_set()
    assert done.wait(5)
    assert time.monotonic() - t0 < 10


def test_delay_sleeps_then_continues():
    with faults.inject(faults.FaultRule("warm_compile", "delay", every=1,
                                        seconds=0.05)):
        t0 = time.monotonic()
        faults.check("warm_compile", key="x")
        assert time.monotonic() - t0 >= 0.04


def test_one_fault_plan_at_a_time():
    with faults.inject(faults.FaultRule("plan_spgemm", "fail")):
        with pytest.raises(RuntimeError, match="already installed"):
            faults.install(faults.FaultPlan([]))
    assert faults.active() is None


def test_checks_are_noops_without_a_plan():
    faults.check("plan_spgemm", key="anything")


@pytest.mark.parametrize("kw, match", [
    (dict(site="nowhere"), "unknown fault site"),
    (dict(site="plan_spgemm", mode="explode"), "unknown fault mode"),
    (dict(site="plan_spgemm", every=0), "every="),
    (dict(site="plan_spgemm", rate=1.5), "rate="),
])
def test_bad_rules_raise_as_in_the_reference(kw, match):
    with pytest.raises(ValueError, match=match):
        faults.FaultRule(**kw)
    with pytest.raises(ValueError, match=match):
        ref_faults.FaultRule(**kw)
    assert faults.SITES == ref_faults.SITES
    assert faults.MODES == ref_faults.MODES
