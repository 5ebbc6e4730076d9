"""The port's training loop and checkpoints: twins of tests/test_trainer.py
(the elastic reshard's is in tests/test_torch_sharding.py), the
``Trainer`` against the JAX package's over three steps, and checkpoints
that cross packages, in one process on the CPU."""
import json
import time
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.data.lm import TokenPipeline as RTokenPipeline
from repro.models import transformer as r_tf
from repro.optim import AdamW as RAdamW
from repro.train.checkpoint import CheckpointManager as RCheckpointManager
from repro.train.trainer import Trainer as RTrainer
from repro.train.trainer import TrainerConfig as RTrainerConfig

from repro_torch.configs.registry import get_config
from repro_torch.data.lm import TokenPipeline
from repro_torch.distributed.compression import compress_grads, init_residuals
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as tf
from repro_torch.optim import AdamW
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.utils import tree
from test_torch_transformer import _both


@pytest.fixture()
def tiny_setup():
    """tests/test_trainer.py's fixture on the port: reduced qwen3-4b (the
    port's reduced_for_port, d_head 32), AdamW(1e-3), batches of 4 x 32."""
    cfg = get_config("qwen3-4b").reduced_for_port()
    params = tf.init(cfg, seed=0, device="cpu")
    opt = AdamW(learning_rate=1e-3)
    ostate = opt.init(params)
    step = tf.make_train_step(cfg, opt, remat=False)
    data = TokenPipeline(cfg.vocab, batch=4, seq_len=32, seed=0)

    def loss_and_grads(params, batch):
        (loss, metrics), grads = tf.value_and_grad(params, batch, cfg)
        return grads, metrics

    def apply(params, grads, ostate):
        return opt.update(params, grads, ostate)

    return cfg, params, ostate, step, data, loss_and_grads, apply


def _copy(state):
    return tree.map_leaves(torch.clone, state)


def _leaves_equal(a, b):
    la, lb = tree.leaves(a), tree.leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def test_checkpoint_roundtrip(tmp_path, tiny_setup):
    cfg, params, ostate, step, data, *_ = tiny_setup
    mgr = CheckpointManager(tmp_path / "ck", keep=2)
    mgr.save(7, {"params": params, "opt_state": ostate}, {"note": "x"})
    restored = mgr.restore({"params": params, "opt_state": ostate})
    assert _leaves_equal(restored["params"], params)
    assert _leaves_equal(restored["opt_state"], ostate)
    assert mgr.latest_step() == 7
    assert mgr.metadata() == {"note": "x"}


def test_checkpoint_gc_keeps_latest(tmp_path, tiny_setup):
    cfg, params, ostate, *_ = tiny_setup
    mgr = CheckpointManager(tmp_path / "ck", keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"params": params})
    assert mgr.all_steps() == [3, 4]


def test_crash_restart_bitwise_resume(tmp_path, tiny_setup):
    """Train 10 steps straight vs crash-at-6 + restart: identical params.

    Data is keyed by step so the restarted run replays the same batches."""
    cfg, params0, ostate0, step, _, *_ = tiny_setup

    def data_from(step_idx):
        def gen():
            i = step_idx
            while True:
                pipe = TokenPipeline(cfg.vocab, batch=4, seq_len=32, seed=100 + i)
                yield next(pipe)
                i += 1
        return gen()

    def make_trainer(fail_at, ckdir, start_params, start_opt):
        # the step updates in place: each trainer starts from its own copy
        return Trainer(
            TrainerConfig(total_steps=10, checkpoint_every=3,
                          checkpoint_dir=str(ckdir), fail_at_step=fail_at,
                          log_every=100),
            step, _copy(start_params), _copy(start_opt), data_from(0))

    t_ref = make_trainer(None, tmp_path / "a", params0, ostate0)
    t_ref.run()

    t_crash = make_trainer(6, tmp_path / "b", params0, ostate0)
    with pytest.raises(RuntimeError, match="injected failure"):
        t_crash.run()
    t_resume = Trainer(
        TrainerConfig(total_steps=10, checkpoint_every=3,
                      checkpoint_dir=str(tmp_path / "b"), log_every=100),
        step, params0, ostate0, None)
    assert t_resume.try_resume()
    assert t_resume.step == 6
    t_resume.data = data_from(t_resume.step)
    t_resume.run()

    assert _leaves_equal(t_ref.params, t_resume.params)
    assert _leaves_equal(t_ref.opt_state, t_resume.opt_state)


def test_straggler_detection(tmp_path, tiny_setup):
    cfg, params, ostate, step, data, *_ = tiny_setup

    def hook(s):
        if s == 5:
            time.sleep(1.0)  # inject a straggler step

    t = Trainer(
        TrainerConfig(total_steps=8, checkpoint_every=100,
                      checkpoint_dir=str(tmp_path / "ck"),
                      straggler_factor=4.0, log_every=100),
        step, params, ostate, data, step_hook=hook)
    out = t.run()
    assert 6 in out["stragglers"]  # step numbering is post-increment
    assert len(out["stragglers"]) <= 2


def test_gradient_compression_convergence(tmp_path, tiny_setup):
    cfg, params, ostate, step, data, loss_and_grads, apply = tiny_setup
    t_plain = Trainer(
        TrainerConfig(total_steps=15, checkpoint_every=100,
                      checkpoint_dir=str(tmp_path / "p"), log_every=100),
        step, _copy(params), _copy(ostate), TokenPipeline(cfg.vocab, 4, 32, seed=5))
    out_plain = t_plain.run()

    t_comp = Trainer(
        TrainerConfig(total_steps=15, checkpoint_every=100,
                      checkpoint_dir=str(tmp_path / "c"),
                      compress_grads=True, log_every=100),
        step, _copy(params), _copy(ostate), TokenPipeline(cfg.vocab, 4, 32, seed=5),
        grad_step_fn=loss_and_grads, apply_fn=apply)
    out_comp = t_comp.run()

    l_plain = out_plain["metrics"][-1]["loss"]
    l_comp = out_comp["metrics"][-1]["loss"]
    l_start = out_plain["metrics"][0]["loss"]
    assert l_comp < l_start              # compressed run still learns
    assert abs(l_comp - l_plain) < 0.25 * l_start  # and stays close


def test_error_feedback_reduces_bias():
    """With error feedback the accumulated quantisation error stays bounded
    and the mean dequantised gradient tracks the true mean."""
    rng = np.random.default_rng(0)
    g_true = torch.as_tensor(rng.normal(size=(256,)).astype(np.float32) * 1e-3)
    res = init_residuals({"w": torch.zeros((256,))})
    acc = torch.zeros((256,))
    for _ in range(50):
        deq, res = compress_grads({"w": g_true}, res)
        acc = acc + deq["w"]
    np.testing.assert_allclose((acc / 50).numpy(), g_true.numpy(), atol=1e-6)


def test_checkpoint_async_saves_serialize_and_close_flushes(tmp_path, tiny_setup):
    """Back-to-back async saves serialize (join-then-spawn under the lock)
    and close() flushes the in-flight writer, so every step is on disk; the
    manager stays usable after close()."""
    cfg, params, ostate, *_ = tiny_setup
    mgr = CheckpointManager(tmp_path / "ck", keep=2, async_save=True)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"params": params, "opt_state": ostate}, {"s": s})
    mgr.close()
    assert mgr.all_steps() == [3, 4]
    restored = mgr.restore({"params": params, "opt_state": ostate})
    assert _leaves_equal(restored["params"], params)
    assert mgr.metadata() == {"s": 4}
    mgr.save(5, {"params": params, "opt_state": ostate})
    mgr.close()
    assert mgr.all_steps() == [4, 5]


def test_async_save_holds_the_values_at_save_time(tmp_path, tiny_setup):
    """An async save of CPU tensors writes their values at save() time,
    although an in-place update overwrites them while the writer runs:
    save() copies every leaf, it never aliases one."""
    cfg, params, *_ = tiny_setup
    before = _copy(params)
    mgr = CheckpointManager(tmp_path / "ck", async_save=True)
    mgr.save(1, {"params": params})
    for t in tree.leaves(params):
        t.zero_()
    mgr.close()
    assert _leaves_equal(mgr.restore({"params": params})["params"], before)


# --- against the JAX package -------------------------------------------------

def _ref_state(seed=0):
    """The reference's {params, opt_state} for reduced qwen3-4b (d_head 32),
    one bf16 leaf added, and the port's tree of the same values."""
    rcfg, rparams, pcfg, params = _both("qwen3-4b", seed)
    ropt, opt = RAdamW(learning_rate=1e-3), AdamW(learning_rate=1e-3)
    rng = np.random.default_rng(seed)
    half = rng.normal(size=(5, 3)).astype(np.float32)
    rstate = {"params": rparams, "opt_state": ropt.init(rparams),
              "extra": {"half": jnp.asarray(half, jnp.bfloat16)}}
    state = {"params": params, "opt_state": opt.init(params),
             "extra": {"half": torch.as_tensor(half).to(torch.bfloat16)}}
    return rstate, state


def _npz_members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def test_reference_checkpoint_restores_into_the_port_bitwise(tmp_path):
    """The reference's checkpoint (bf16 leaf as its raw |V2 bytes) restores
    into the port's tree bit for bit, bf16 leaf included."""
    rstate, state = _ref_state()
    RCheckpointManager(tmp_path / "r").save(3, rstate, {"from": "jax"})
    mgr = CheckpointManager(tmp_path / "r")
    got = mgr.restore(state)
    assert mgr.metadata() == {"from": "jax"} and mgr.latest_step() == 3
    for g, w in zip(tree.leaves(got), jax.tree.leaves(rstate)):
        if g.dtype == torch.bfloat16:
            assert np.array_equal(g.view(torch.int16).numpy(),
                                  np.asarray(w).view(np.int16))
        else:
            assert np.array_equal(g.numpy(), np.asarray(w))


def test_port_checkpoint_is_the_reference_format_bitwise(tmp_path):
    """The port writes what the reference writes: the same manifest keys and
    every npz member (bf16 leaf included) byte for byte; and the reference
    restores the port's float32 and int leaves bit for bit (its restore
    cannot take a bf16 leaf, its own included: jnp.asarray refuses |V2)."""
    rstate, state = _ref_state(1)
    CheckpointManager(tmp_path / "p").save(4, state)
    RCheckpointManager(tmp_path / "r").save(4, rstate)
    man_p = json.loads((tmp_path / "p" / "step_0000000004" / "manifest.json").read_text())
    man_r = json.loads((tmp_path / "r" / "step_0000000004" / "manifest.json").read_text())
    assert man_p["keys"] == man_r["keys"]
    assert _npz_members(tmp_path / "p" / "step_0000000004" / "arrays.npz") == \
        _npz_members(tmp_path / "r" / "step_0000000004" / "arrays.npz")
    like = {k: rstate[k] for k in ("params", "opt_state")}
    CheckpointManager(tmp_path / "p2").save(5, {k: state[k] for k in like})
    restored = RCheckpointManager(tmp_path / "p2").restore(like)
    for g, w in zip(jax.tree.leaves(restored), jax.tree.leaves(like)):
        assert np.array_equal(np.asarray(g), np.asarray(w))


def test_trainer_steps_match_the_reference_trainer(tmp_path):
    """Three Trainer steps of reduced qwen3-4b (d_head 32) on the same
    weights and TokenPipeline batches: each step's loss within 1e-5 of the
    reference Trainer's, the parameters after within 1e-5."""
    rcfg, rparams, pcfg, params = _both("qwen3-4b")
    ropt, opt = RAdamW(learning_rate=1e-3), AdamW(learning_rate=1e-3)
    rt = RTrainer(RTrainerConfig(total_steps=3, checkpoint_every=100,
                                 checkpoint_dir=str(tmp_path / "r"), log_every=100),
                  jax.jit(r_tf.make_train_step(rcfg, ropt, remat=False)), rparams,
                  ropt.init(rparams), RTokenPipeline(rcfg.vocab, 2, 24, seed=9))
    pt = Trainer(TrainerConfig(total_steps=3, checkpoint_every=100,
                               checkpoint_dir=str(tmp_path / "p"), log_every=100),
                 tf.make_train_step(pcfg, opt, remat=False), params, opt.init(params),
                 TokenPipeline(pcfg.vocab, 2, 24, seed=9))
    rout, pout = rt.run(), pt.run()
    for a, b in zip(pout["metrics"], rout["metrics"]):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
    for g, w in zip(tree.leaves(pt.params), jax.tree.leaves(rt.params)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_launcher_trains_and_resumes_on_the_cpu(tmp_path):
    """``launch/train.py``'s trainer (reduced qwen3-4b, cosine AdamW, in
    place updates) learns over a few steps, and a second trainer in its
    checkpoint directory resumes at the last checkpoint with the first
    one's parameters."""
    t = launch_train.build_trainer(steps=4, batch=2, seq_len=32, ckpt_dir=str(tmp_path),
                                   device="cpu", checkpoint_every=2)
    out = t.run()
    assert out["final_step"] == 4 and all(np.isfinite(m["loss"]) for m in out["metrics"])
    t2 = launch_train.build_trainer(steps=4, batch=2, seq_len=32, ckpt_dir=str(tmp_path),
                                    device="cpu", checkpoint_every=2)
    assert t2.try_resume() and t2.step == 4
    assert _leaves_equal(t2.params, t.params)
    with pytest.raises(SystemExit):
        launch_train.build_trainer(arch="dlrm-rm2", device="cpu")
