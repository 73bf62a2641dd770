"""The port's training loop (``repro_torch.training.train_loop``) on the
CPU: the reference's ``Trainer`` and train-step tests
(``tests/test_training.py``), each mirrored on the port, the watchdog and
the preemption handler, and ``examples/torch_train_lm.py``'s quick preset.
The optimizer, data, schedule and checkpoint mirrors are in
``tests/test_torch_training.py``; the steps against the reference's in
``tests/test_torch_training_steps.py``."""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config
from repro_torch.models import smoke
from repro_torch.training import (
    DataConfig, SyntheticLoader, TrainConfig, Trainer, build_train_step,
    init_train_state, latest_checkpoint, restore_checkpoint, synth_batch,
)
from repro_torch.training.tree import tree_map
from torch_training_parity import one_thread  # noqa: F401


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_trainer_resume_replays_stream(tmp_path):
    """Kill/restart drill: loss trajectory must continue, not restart."""
    cfg = smoke(get_config("qwen2-0.5b"))
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4, seed=1)
    tc = TrainConfig(total_steps=6, checkpoint_dir=str(tmp_path / "run"),
                     checkpoint_every=3, log_every=100, peak_lr=1e-3,
                     warmup_steps=2)
    state = init_train_state(cfg, tc, gen(), device="cpu")
    t1 = Trainer(cfg, tc, SyntheticLoader(dcfg, device="cpu"), state)
    t1.run(n_steps=4)  # checkpoints at step 3
    # simulated crash: new trainer, fresh state, auto-resume
    state2 = init_train_state(cfg, tc, gen(), device="cpu")
    t2 = Trainer(cfg, tc, SyntheticLoader(dcfg, device="cpu"), state2)
    assert t2.try_resume()
    assert t2.step_idx == 3
    assert t2.loader.step == 3
    t2.run(n_steps=2)
    assert t2.step_idx == 5


def test_trainer_loss_decreases():
    cfg = dataclasses.replace(smoke(get_config("qwen2-0.5b")), vocab=128)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=8, seed=2,
                      noise=0.0, n_maps=2)
    tc = TrainConfig(total_steps=80, peak_lr=2e-2, warmup_steps=10,
                     log_every=100)
    state = init_train_state(cfg, tc, gen(), device="cpu")
    t = Trainer(cfg, tc, SyntheticLoader(dcfg, device="cpu"), state)
    log = t.run()
    first = np.mean([m["loss"] for m in log[:5]])
    last = np.mean([m["loss"] for m in log[-5:]])
    # must both decrease and beat the uniform floor ln(128)=4.85
    assert last < first - 0.4, (first, last)
    assert last < 4.85, last


def test_accum_steps_equivalent_loss_scale():
    """accum=2 and accum=1 see the same data => similar first-step loss."""
    cfg = smoke(get_config("qwen2-0.5b"))
    tc1 = TrainConfig(accum_steps=1)
    tc2 = TrainConfig(accum_steps=2)
    state = init_train_state(cfg, tc1, gen(), device="cpu")
    batch = synth_batch(DataConfig(cfg.vocab, 64, 4, seed=3), 0)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    s1 = build_train_step(cfg, tc1)
    s2 = build_train_step(cfg, tc2)
    _, m1 = s1(tree_map(torch.clone, state), batch, 0)
    _, m2 = s2(tree_map(torch.clone, state), batch, 0)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-3)


def _tiny_trainer(tmp_path, **kw):
    cfg = smoke(get_config("qwen2-0.5b"))
    tc = TrainConfig(total_steps=4, log_every=100, **kw)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2, seed=1)
    state = init_train_state(cfg, tc, gen(), device="cpu")
    return cfg, tc, dcfg, state


def test_straggler_watchdog_warns_past_the_factor(tmp_path):
    """A step slower than ``straggler_factor`` times the median of the
    earlier ones (once ten are known) calls ``on_warning``."""
    cfg, tc, dcfg, state = _tiny_trainer(tmp_path)
    warned = []
    t = Trainer(cfg, tc, SyntheticLoader(dcfg, device="cpu"), state,
                on_warning=warned.append)
    for dt in [1.0] * 9 + [2.9]:
        t._watchdog(dt)
    assert warned == []
    t._watchdog(3.1)
    assert len(warned) == 1 and "straggler" in warned[0]


def test_preemption_checkpoints_and_stops(tmp_path):
    """The preemption handler's signal stops the loop before its next step
    and leaves a checkpoint of the state and the data position."""
    import signal

    cfg, tc, dcfg, state = _tiny_trainer(
        tmp_path, checkpoint_dir=str(tmp_path / "run"), checkpoint_every=0)
    t = Trainer(cfg, tc, SyntheticLoader(dcfg, device="cpu"), state)
    old = signal.getsignal(signal.SIGUSR1)
    try:
        t.install_preemption_handler(signal.SIGUSR1)
        t.run(n_steps=1)
        os.kill(os.getpid(), signal.SIGUSR1)
        log = t.run(n_steps=2)
    finally:
        signal.signal(signal.SIGUSR1, old)
    assert [m["step"] for m in log] == [1]
    path = latest_checkpoint(str(tmp_path / "run"))
    assert path.endswith("step_00000001")
    _, step, extra = restore_checkpoint(path, t.state)
    assert step == 1 and extra == {"data": {"step": 1, "seed": 1}}


def test_the_train_lm_example_runs_on_the_cpu(tmp_path, monkeypatch):
    """``examples/torch_train_lm.py``'s 15m preset, two steps on the host:
    finite losses, and its checkpoint under ``.cache/torch_train_lm``."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "torch_train_lm.py")
    spec = importlib.util.spec_from_file_location("torch_train_lm", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    monkeypatch.chdir(tmp_path)
    log = example.main(["--device", "cpu", "--steps", "2"])
    assert [m["step"] for m in log] == [1, 2]
    assert np.isfinite([m["loss"] for m in log]).all()
    assert latest_checkpoint(".cache/torch_train_lm/15m").endswith(
        "step_00000002")
