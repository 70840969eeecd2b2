"""The port's checkpoints against the reference's, on the CPU: the same
manifest and the same bytes for the same train state, checkpoints crossing
between the two packages both ways, the reference's round-trip, retention
and shape tests, training interrupted and resumed bit for bit, bfloat16
leaves (which the reference writes but cannot restore), the async save's
host snapshot, the in-place restore, and ``shardings=``."""
import threading
import zipfile
from dataclasses import replace

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as ref_C
from repro.ckpt import manager as ref_M
from repro.configs import get_config as ref_get_config
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.models import build_model as ref_build_model
from repro.train import train_step as ref_ts
from repro_torch.ckpt import CheckpointManager, checkpoint as C, latest, list_steps, restore, save
from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch.train import to_device
from repro_torch.models import build_model
from repro_torch.train import train_step as TS

ARCH = "qwen2.5-3b"
STATES = {"adamw": {},
          "adafactor_int8_bf16_state": {"optimizer": "adafactor", "grad_compression": "int8",
                                        "opt_state_dtype": "bfloat16"}}


def _ref_state_numpy(ref_state):
    """What ``TS.train_state_from_reference`` takes."""
    opt_np = {k: jax.tree.map(np.asarray, v) for k, v in ref_state.opt_state._asdict().items()}
    residual = (None if ref_state.residual is None
                else jax.tree.map(np.asarray, ref_state.residual))
    return jax.tree.map(np.asarray, ref_state.params), opt_np, residual


class Pair:
    """A reduced model in both packages (float32 compute, parameters in the
    config's dtype), the reference's initial state and the port's copy."""

    def __init__(self, **tc):
        self.ref_cfg = replace(ref_get_config(ARCH).reduced(), compute_dtype="float32")
        self.cfg = replace(get_config(ARCH).reduced(), compute_dtype="float32")
        tc = dict(dict(learning_rate=1e-2, warmup_steps=1, total_steps=10), **tc)
        self.ref_tcfg, self.tcfg = RefTrainConfig(**tc), TrainConfig(**tc)
        self.ref_api, self.api = ref_build_model(self.ref_cfg), build_model(self.cfg)
        self.ref_state = ref_ts.init_state(self.ref_api, self.ref_tcfg, jax.random.PRNGKey(0))
        self.ref_step = jax.jit(ref_ts.make_train_step(self.ref_api, self.ref_tcfg))
        self.step = TS.make_train_step(self.api, self.tcfg)
        self.source = SyntheticLM(DataConfig(vocab_size=self.cfg.vocab_size), self.cfg)

    def port_state(self, ref_state=None):
        return TS.train_state_from_reference(*_ref_state_numpy(ref_state or self.ref_state),
                                             device="cpu")

    def batch(self, i):
        return self.source.batch_at(i, 4, 16)


def _members(path):
    """Every zip member's bytes of every shard under a step directory."""
    out = {}
    for shard in sorted(path.glob("shard_*.npz")):
        with zipfile.ZipFile(shard) as z:
            for name in z.namelist():
                out[(shard.name, name)] = z.read(name)
    return out


def _bits(x):
    """A leaf's bytes as numpy, whichever package it came from."""
    if isinstance(x, torch.Tensor):
        t = x.detach().contiguous()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()
    return np.asarray(x).tobytes()


# ------------------------------------------------------- the same format
@pytest.mark.parametrize("case", sorted(STATES))
def test_train_state_checkpoint_has_the_reference_manifest_and_bytes(case, tmp_path):
    """The reference's state and the port's copy of it: the same leaf keys,
    shapes, dtype names, shards and npz keys, and every shard member the
    same bytes (a small ``max_shard_bytes`` splits the state over shards)."""
    pair = Pair(**STATES[case])
    ref_dir = ref_C.save(pair.ref_state, tmp_path / "ref", step=3, max_shard_bytes=1 << 16)
    port_dir = save(pair.port_state(), tmp_path / "port", step=3, max_shard_bytes=1 << 16)
    ref_m, port_m = ref_C.load_manifest(ref_dir), C.load_manifest(port_dir)
    assert list(port_m["leaves"].items()) == list(ref_m["leaves"].items())
    assert port_m["shards"] == ref_m["shards"] and len(port_m["shards"]) > 1
    assert {k: port_m[k] for k in ("format", "step", "extra")} \
        == {k: ref_m[k] for k in ("format", "step", "extra")}
    assert _members(port_dir) == _members(ref_dir)
    dtypes = {m["dtype"] for m in port_m["leaves"].values()}
    assert dtypes == ({"float32", "int32", "bfloat16"} if case != "adamw"
                      else {"float32", "int32"})


def test_abstract_state_has_the_reference_leaves():
    for tc in STATES.values():
        api = build_model(get_config(ARCH).reduced())
        ref_api = ref_build_model(ref_get_config(ARCH).reduced())
        port = [(k, tuple(v.shape), str(v.dtype).replace("torch.", ""), v.device.type)
                for k, v in C._flatten_with_paths(TS.abstract_state(api, TrainConfig(**tc)))]
        ref = [(k, tuple(v.shape), str(v.dtype), "meta") for k, v in ref_C._flatten_with_paths(
            ref_ts.abstract_state(ref_api, RefTrainConfig(**tc)))]
        assert port == ref


# ------------------------------------------------------ across packages
def test_reference_checkpoint_restores_in_the_port_and_trains_on(tmp_path):
    """The reference trains one step and saves; the port restores into its
    abstract state, bit-equal to ``train_state_from_reference`` of the same
    state; two more steps match the reference's losses (1e-4 relative, the
    tolerance of ``test_torch_train.py``)."""
    pair = Pair()
    ref_state, _ = pair.ref_step(pair.ref_state,
                                 {k: jnp.asarray(v) for k, v in pair.batch(0).items()})
    ref_C.save(ref_state, tmp_path, step=1)
    state, manifest = restore(latest(tmp_path), TS.abstract_state(pair.api, pair.tcfg),
                              device="cpu")
    assert manifest["step"] == 1
    want = pair.port_state(ref_state)
    got_leaves, want_leaves = C.leaves(state), C.leaves(want)
    assert len(got_leaves) == len(want_leaves) == 43
    for got, w in zip(got_leaves, want_leaves):
        assert got.dtype == w.dtype and got.device.type == "cpu" and torch.equal(got, w)
    for i in (1, 2):
        ref_state, ref_m = pair.ref_step(ref_state,
                                         {k: jnp.asarray(v) for k, v in pair.batch(i).items()})
        state, m = pair.step(state, to_device(pair.batch(i), "cpu"))
        np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]), float(ref_m["grad_norm"]), rtol=1e-4)
    assert int(state.opt_state.step) == 3


def test_port_float32_checkpoint_restores_in_the_reference(tmp_path):
    pair = Pair()
    state, _ = pair.step(pair.port_state(), to_device(pair.batch(0), "cpu"))
    save(state, tmp_path, step=1)
    template = ref_ts.abstract_state(pair.ref_api, pair.ref_tcfg)
    ref_tree, manifest = ref_C.restore(ref_C.latest(tmp_path), target_tree=template)
    assert manifest["step"] == 1
    ref_leaves = jax.tree.leaves(ref_tree)
    assert len(ref_leaves) == len(C.leaves(state)) == 43
    for got, mine in zip(ref_leaves, C.leaves(state)):
        assert str(got.dtype) == str(mine.dtype).replace("torch.", "")
        assert _bits(got) == _bits(mine)


# ------------------------------------- the reference's substrate tests
def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones((5,), dtype=torch.int32)}}
    save(tree, tmp_path, step=10)
    out, manifest = restore(latest(tmp_path), target_tree={
        "a": torch.empty((3, 4), device="meta"),
        "b": {"c": torch.empty((5,), dtype=torch.int32, device="meta")}}, device="cpu")
    assert manifest["step"] == 10
    assert torch.equal(out["a"], tree["a"]) and torch.equal(out["b"]["c"], tree["b"]["c"])
    assert out["b"]["c"].dtype == torch.int32
    flat, _ = restore(latest(tmp_path))
    assert list(flat) == ["a", "b/c"] and torch.equal(flat["b/c"], tree["b"]["c"])


def test_checkpoint_atomic_and_retention(tmp_path):
    mgr = CheckpointManager(tmp_path, save_every=2, keep=2, async_save=False)
    tree = {"w": torch.zeros((4,))}
    for step in (2, 4, 6, 8):
        assert mgr.should_save(step)
        mgr.save(tree, step)
    assert not mgr.should_save(0) and not mgr.should_save(3)
    assert list_steps(tmp_path) == [6, 8]      # retention kept last 2
    assert not list(tmp_path.glob(".tmp_step_*"))
    restored, step = mgr.restore_latest(target_tree=tree)
    assert step == 8 and restored["w"] is tree["w"]
    assert CheckpointManager(tmp_path / "none").restore_latest() == (None, 0)


def test_checkpoint_shape_mismatch_and_missing_leaf_raise_as_the_reference(tmp_path):
    save({"w": torch.zeros((4,))}, tmp_path / "port", step=1)
    ref_C.save({"w": jnp.zeros((4,))}, tmp_path / "ref", step=1)
    messages = []
    for err, port_target, ref_target in (
            (ValueError, {"w": torch.zeros((5,))}, {"w": jnp.zeros((5,))}),
            (KeyError, {"v": torch.zeros((4,))}, {"v": jnp.zeros((4,))})):
        with pytest.raises(err) as port_err:
            restore(latest(tmp_path / "port"), target_tree=port_target)
        with pytest.raises(err) as ref_err:
            ref_C.restore(ref_C.latest(tmp_path / "ref"), target_tree=ref_target)
        messages.append((str(port_err.value), str(ref_err.value)))
    assert all(port == ref for port, ref in messages), messages


def test_shape_check_runs_before_any_leaf_is_overwritten(tmp_path):
    save({"a": torch.ones(3), "b": torch.ones(2)}, tmp_path, step=1)
    live = {"a": torch.zeros(3), "b": torch.zeros(5)}
    with pytest.raises(ValueError, match="b: checkpoint shape"):
        restore(latest(tmp_path), target_tree=live)
    assert torch.equal(live["a"], torch.zeros(3))


def _tiny_train(api, tcfg, source, n, mgr=None, state=None, start=0):
    step_fn = TS.make_train_step(api, tcfg)
    if state is None:
        state = TS.init_state(api, tcfg, device="cpu")
    loss = None
    for i in range(start, n):
        state, m = step_fn(state, to_device(source.batch_at(i, 4, 32), "cpu"))
        if mgr and mgr.should_save(i + 1):
            mgr.save(state, i + 1, block=True)
        loss = float(m["loss"])
    return state, loss


def test_checkpoint_restart_bitwise_resume(tmp_path):
    """``tests/test_integration.py``'s case in the port: training
    interrupted at step 6 and resumed from the step-4 checkpoint replays to
    the same final loss and state as an uninterrupted run, bit for bit."""
    cfg = get_config(ARCH).reduced()
    api = build_model(cfg)
    tcfg = TrainConfig(total_steps=50, warmup_steps=2, learning_rate=1e-3)
    source = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seed=3), cfg)
    ref_state, ref_loss = _tiny_train(api, tcfg, source, 8)
    mgr = CheckpointManager(tmp_path, save_every=4, keep=2, async_save=False)
    state, _ = _tiny_train(api, tcfg, source, 6, mgr=mgr)
    del state                                          # "crash"
    restored, step = mgr.restore_latest(target_tree=TS.abstract_state(api, tcfg),
                                        device="cpu")
    assert step == 4
    resumed, resumed_loss = _tiny_train(api, tcfg, source, 8, state=restored, start=step)
    assert resumed_loss == ref_loss
    for got, want in zip(C.leaves(resumed), C.leaves(ref_state)):
        assert torch.equal(got, want)


# ------------------------------------------------------------- bfloat16
def test_bf16_leaf_round_trips_in_the_port_and_not_in_the_reference(tmp_path):
    """A bf16 leaf is written as the reference writes one (``<V2`` records,
    ``"dtype": "bfloat16"``) and comes back as ``torch.bfloat16``.  The
    reference's ``restore`` of the same directory raises ``TypeError``
    (``jax.device_put`` of a ``|V2`` array): a reference fault, pinned here."""
    w = torch.randn(5, 3, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    tree = {"w": w, "n": torch.arange(4, dtype=torch.float32)}
    save(tree, tmp_path, step=1)
    assert C.load_manifest(latest(tmp_path))["leaves"]["w"]["dtype"] == "bfloat16"
    out, _ = restore(latest(tmp_path), target_tree={"w": torch.empty((5, 3), device="meta"),
                                                    "n": torch.empty(4, device="meta")},
                     device="cpu")
    assert out["w"].dtype == torch.bfloat16 and torch.equal(out["w"], w)
    live = {"w": torch.zeros(5, 3, dtype=torch.bfloat16), "n": torch.zeros(4)}
    restore(latest(tmp_path), target_tree=live)
    assert torch.equal(live["w"], w)
    with pytest.raises(TypeError, match="V2"):
        ref_C.restore(ref_C.latest(tmp_path),
                      target_tree={"w": jnp.zeros((5, 3), jnp.bfloat16), "n": jnp.zeros(4)})
    raw, _ = ref_C.restore(ref_C.latest(tmp_path))
    assert raw["w"].dtype.kind == "V"                  # no target: opaque records
    # and a bf16 leaf the reference writes restores in the port
    ref_w = np.asarray(w.float().numpy()).astype(ml_dtypes.bfloat16)
    ref_C.save({"w": jnp.asarray(ref_w)}, tmp_path / "ref", step=2)
    got, _ = restore(latest(tmp_path / "ref"))
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], w)


# ------------------------------------------------- in place, async, shardings
def test_async_save_keeps_the_values_of_its_step(tmp_path, monkeypatch):
    """The train step updates the state in place: a change made right after
    an async ``save`` returns, while the file is still to be written, must
    not reach the checkpoint."""
    changed = threading.Event()
    real_save = C.save

    def late_save(*args, **kw):
        assert changed.wait(30)
        return real_save(*args, **kw)

    monkeypatch.setattr(C, "save", late_save)
    tree = {"w": torch.arange(6.0), "s": torch.zeros((), dtype=torch.int32)}
    mgr = CheckpointManager(tmp_path, save_every=1, async_save=True)
    mgr.save(tree, 1)
    tree["w"].add_(100.0)
    tree["s"].fill_(7)
    changed.set()
    mgr.wait()
    out, step = mgr.restore_latest()
    assert step == 1 and torch.equal(out["w"], torch.arange(6.0)) and int(out["s"]) == 0


def test_restore_latest_waits_for_the_save_in_flight(tmp_path, monkeypatch):
    started = threading.Event()
    real_save = C.save

    def slow_save(*args, **kw):
        started.set()
        threading.Event().wait(0.2)
        return real_save(*args, **kw)

    monkeypatch.setattr(C, "save", slow_save)
    mgr = CheckpointManager(tmp_path, save_every=1, async_save=True)
    mgr.save({"w": torch.ones(3)}, 4)
    assert started.wait(30)
    live = {"w": torch.zeros(3)}
    tree, step = mgr.restore_latest(target_tree=live)
    assert step == 4 and torch.equal(live["w"], torch.ones(3))


def test_in_place_restore_keeps_every_tensor(tmp_path):
    pair = Pair(optimizer="adafactor", grad_compression="int8")
    state = pair.port_state()
    save(state, tmp_path, step=2)
    ptrs = [t.data_ptr() for t in C.leaves(state)]
    saved = [t.clone() for t in C.leaves(state)]
    state, _ = pair.step(state, to_device(pair.batch(0), "cpu"))   # in place, as on the card
    out, _ = restore(latest(tmp_path), target_tree=state)
    assert out is not state and isinstance(out, TS.TrainState)
    for got, live, want in zip(C.leaves(out), C.leaves(state), saved):
        assert got is live and torch.equal(got, want)
    moved = [t.data_ptr() for t in C.leaves(state)]
    # the step replaced only the step counter and the residual's tensors
    assert sum(a != b for a, b in zip(ptrs, moved)) == 1 + len(C.leaves(state.residual))


def test_restore_with_shardings_places_each_leafs_slice(tmp_path):
    """``restore(shardings=)`` reads each fully gathered stored leaf and
    keeps the slice the sharding names, bit-equal, for every rank of a 2x2
    mesh (planned only: no process group); a target of the slice's shape is
    filled in place, a None sharding keeps its leaf whole; the manager
    passes the shardings on."""
    from repro_torch.parallel.sharding import P, Mesh, Sharding
    gen = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn(4, 6, generator=gen), "b": torch.randn(8, generator=gen),
            "n": torch.arange(8, dtype=torch.int32)}
    save(tree, tmp_path, step=3)
    for rank in range(4):
        mesh = Mesh(("data", "model"), (2, 2), rank=rank)
        sh = {"w": Sharding(mesh, P("data", "model")), "b": Sharding(mesh, P(("data", "model"))),
              "n": None}
        live = {"w": torch.zeros(2, 3), "b": torch.zeros(2), "n": torch.zeros(8, dtype=torch.int32)}
        out, _ = restore(latest(tmp_path), target_tree=live, shardings=sh, device="cpu")
        d, m = divmod(rank, 2)
        assert all(out[k] is live[k] for k in live)
        assert torch.equal(out["w"], tree["w"][2 * d:2 * d + 2, 3 * m:3 * m + 3])
        # one dim over two mesh axes: the block is row-major over (data, model)
        assert torch.equal(out["b"], tree["b"][2 * rank:2 * rank + 2])
        assert torch.equal(out["n"], tree["n"])
        meta = {k: torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in tree.items()}
        got, step = CheckpointManager(tmp_path).restore_latest(target_tree=meta, shardings=sh,
                                                               device="cpu")
        assert step == 3 and torch.equal(got["w"], out["w"]) and got["w"].is_contiguous()


def test_manager_api_mirrors_the_reference():
    import inspect
    for name in ("__init__", "should_save", "save", "wait", "_gc"):
        assert inspect.signature(getattr(CheckpointManager, name)) \
            == inspect.signature(getattr(ref_M.CheckpointManager, name)), name
    assert C.FORMAT_VERSION == ref_C.FORMAT_VERSION == 2
