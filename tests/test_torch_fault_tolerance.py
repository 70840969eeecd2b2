"""The port's fault tolerance against the reference's, on the CPU.

The scenarios of ``tests/test_substrate.py`` (heartbeats, stragglers, the
driver's restore and replay, retry exhaustion, straggler and rescale
events) run through both packages' ``runtime``, the replay scenario with
each package's own checkpoint manager and arrays; each scenario asserts the
reference test's properties and returns what it saw (dead and alive hosts,
stragglers, the driver's events, final state and step), and the two
packages' outcomes must be equal.
"""
import types

import jax.numpy as jnp
import pytest
import torch

import repro.ckpt as ref_ckpt
import repro.runtime as ref_runtime
import repro.runtime.faults as ref_faults
import repro_torch.ckpt as port_ckpt
import repro_torch.runtime as port_runtime
import repro_torch.runtime.faults as port_faults

PKGS = {
    "ref": types.SimpleNamespace(rt=ref_runtime, ckpt=ref_ckpt, faults=ref_faults,
                                 zeros=lambda: jnp.zeros(()), ones=lambda: jnp.ones(())),
    "port": types.SimpleNamespace(rt=port_runtime, ckpt=port_ckpt, faults=port_faults,
                                  zeros=lambda: torch.zeros(()), ones=lambda: torch.ones(())),
}


def _events(drv):
    return [(e.step, e.kind, e.detail) for e in drv.events]


def heartbeat_failure(k, tmp):
    reg = k.rt.HeartbeatRegistry(4, timeout_s=10.0)
    for h in range(4):
        reg.beat(h, step=1, step_time_s=1.0, now=100.0)
    reg.beat(0, 2, 1.0, now=120.0)
    assert set(reg.dead_hosts(now=120.0)) == {1, 2, 3}
    return {"dead": reg.dead_hosts(now=120.0), "alive": reg.alive_hosts(now=120.0)}


def straggler_detection(k, tmp):
    reg = k.rt.HeartbeatRegistry(4, timeout_s=1e9)
    for step in range(10):
        for h in range(4):
            reg.beat(h, step, 1.0 if h != 2 else 3.0, now=float(step))
    tracker = k.rt.StragglerTracker(reg)
    assert tracker.stragglers() == [2]
    return {"stragglers": tracker.stragglers(), "medians": tracker.medians()}


def silent_from_birth(k, tmp):
    reg = k.rt.HeartbeatRegistry(3, timeout_s=10.0, now=0.0)
    reg.beat(1, 0, 1.0, now=5.0)
    reg.beat(2, 0, 1.0, now=5.0)
    dead = [reg.dead_hosts(now=t) for t in (9.0, 10.0, 11.0, 16.0)]
    assert dead[:3] == [[], [], [0]] and set(dead[3]) == {0, 1, 2}
    return dead


def stragglers_need_two_hosts(k, tmp):
    reg = k.rt.HeartbeatRegistry(4, timeout_s=1e9, now=0.0)
    for step in range(10):
        reg.beat(0, step, 9.0, now=float(step))
    assert k.rt.StragglerTracker(reg).stragglers() == []
    return k.rt.StragglerTracker(reg).medians()


def driver_restores_and_replays(k, tmp):
    """A failure at the sixth call: the driver restores from the step-4
    checkpoint and replays; deterministic data => the failure-free result."""
    calls = {"n": 0}

    def step_fn(state, batch):
        calls["n"] += 1
        if calls["n"] == 6 and not calls.get("failed"):
            calls["failed"] = True
            raise RuntimeError("injected device loss")
        return state + batch, {"loss": float(state)}

    mgr = k.ckpt.CheckpointManager(tmp, save_every=2, keep=5, async_save=False)

    def restore_fn():
        tree, step = mgr.restore_latest(target_tree=k.zeros())
        return (tree if tree is not None else k.zeros()), step

    drv = k.rt.ResilientDriver(step_fn, mgr)
    state, step, metrics = drv.run(k.zeros(), lambda step: k.ones(), start_step=0,
                                   n_steps=10, restore_fn=restore_fn)
    assert step == 10 and float(state) == 10.0
    assert [e.kind for e in drv.events] == ["restart"]
    return {"state": float(state), "step": step, "loss": metrics["loss"],
            "events": _events(drv), "calls": calls["n"],
            "kept": k.ckpt.list_steps(tmp)}


def driver_requires_restore_path(k, tmp):
    drv = k.rt.ResilientDriver(lambda s, b: (s, {}), None)
    with pytest.raises(ValueError, match="restore_fn") as err:
        drv.run(0, lambda step: None, start_step=0, n_steps=1)
    drv0 = k.rt.ResilientDriver(lambda s, b: 1 / 0, None, max_retries=0)
    with pytest.raises(ZeroDivisionError):
        drv0.run(0, lambda step: None, start_step=0, n_steps=1)
    return {"message": str(err.value), "events": _events(drv0)}


def retry_exhaustion(k, tmp):
    def step_fn(state, batch):
        raise RuntimeError("persistent device loss")

    drv = k.rt.ResilientDriver(step_fn, None, max_retries=2)
    with pytest.raises(RuntimeError, match="persistent"):
        drv.run(0, lambda step: None, start_step=0, n_steps=4, restore_fn=lambda: (0, 0))
    assert [e.kind for e in drv.events] == ["restart"] * 3
    return _events(drv)


def straggler_events(k, tmp):
    clock = {"t": 100.0}
    reg = k.rt.HeartbeatRegistry(3, timeout_s=1e9, now=clock["t"])
    for step in range(10):
        reg.beat(1, step, 5.0, now=100.0)
        reg.beat(2, step, 1.0, now=100.0)

    def step_fn(state, batch):
        clock["t"] += 1.0
        return state + 1, {}

    drv = k.rt.ResilientDriver(step_fn, None, max_retries=0, registry=reg,
                               tracker=k.rt.StragglerTracker(reg), clock=lambda: clock["t"])
    state, step, _ = drv.run(0, lambda step: None, start_step=0, n_steps=3)
    straggler = [e for e in drv.events if e.kind == "straggler"]
    assert state == 3 and step == 3 and len(straggler) == 1 and "host 1" in straggler[0].detail
    return {"state": state, "events": _events(drv)}


def rescale_events(k, tmp):
    clock = {"t": 0.0}
    reg = k.rt.HeartbeatRegistry(2, timeout_s=5.0, now=0.0)
    calls = []

    def step_fn(state, batch):
        clock["t"] += 4.0
        return state, {}

    drv = k.rt.ResilientDriver(step_fn, None, max_retries=0, registry=reg,
                               rescale_fn=lambda dead, alive: calls.append((dead, alive)),
                               clock=lambda: clock["t"])
    drv.run(0, lambda step: None, start_step=0, n_steps=3)
    rescale = [e for e in drv.events if e.kind == "rescale"]
    assert len(rescale) == 1 and "[1]" in rescale[0].detail and calls == [([1], [0])]
    return {"events": _events(drv), "calls": calls}


def injected_straggler_scale(k, tmp):
    """``REPRO_FAULTS`` straggler factors scale what the driver reports
    into the registry, as ``launch/train.py`` wires them."""
    sched = k.faults.parse_faults("straggler:0:3@2")
    clock = {"t": 0.0}
    reg = k.rt.HeartbeatRegistry(1, timeout_s=1e9, now=0.0)

    def step_fn(state, batch):
        clock["t"] += 1.0
        return state + 1, {}

    drv = k.rt.ResilientDriver(step_fn, None, max_retries=0, registry=reg,
                               tracker=k.rt.StragglerTracker(reg), clock=lambda: clock["t"],
                               step_time_scale=lambda s: sched.straggler_factor(0, s))
    drv.run(0, lambda step: None, start_step=0, n_steps=4)
    return {"describe": sched.describe(), "times": list(reg.hosts[0].step_times),
            "events": _events(drv)}


SCENARIOS = {f.__name__: f for f in (
    heartbeat_failure, straggler_detection, silent_from_birth, stragglers_need_two_hosts,
    driver_restores_and_replays, driver_requires_restore_path, retry_exhaustion,
    straggler_events, rescale_events, injected_straggler_scale)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_fault_tolerance_scenario_matches_reference(name, tmp_path):
    out = {}
    for side, k in PKGS.items():
        (tmp_path / side).mkdir()
        out[side] = SCENARIOS[name](k, tmp_path / side)
    assert out["port"] == out["ref"]
