"""The port's trainer (devo_tpu_torch/train/trainer.py) against devo_tpu's
optax chain, and its entry points on the CPU: the one-cycle schedule at
every step, the optimizer step (clip, AdamW, the non-finite rules) on the
same gradient trees over 3 steps across the warmup's end, a checkpoint
resume bit for bit (the cheap counterpart of the `slow`
tests/test_train.py:116), one DistributedDataParallel step over gloo in 2
processes against one process with the batch of 2, `python -m
devo_tpu_torch.train --device cpu` for 2 steps on the fake TartanAir-EVS
tree (tests/test_torch_tartan.make_tree) with a checkpoint, a resume and a
validation round, the CLI's `tartanair` branch on that tree, validation's
record of a failed scene, and the warm start.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from devo_tpu.nets.evonet import EVONet as JNet
from devo_tpu.train.trainer import make_optimizer, one_cycle_linear as jsched
from devo_tpu_torch.eval import cli
from devo_tpu_torch.nets.evonet import EVONet
from devo_tpu_torch.train.trainer import Trainer, one_cycle_linear
from devo_tpu_torch.train.validate import validate_tartan_evs
from devo_tpu_torch.utils.params import (jax_params_to_state_dict,
                                         random_state_dict, warm_start)

from test_torch_tartan import make_tree
from test_torch_train_forward import make_inputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = dict(dim_inet=32, dim_fnet=16, dim=8)
SMALL = dict(steps_unrolled=3, ppi=4, grow_after=2)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- schedule

@pytest.mark.parametrize("lr,total", [(8e-5, 240_000), (8e-5, 300),
                                      (1e-3, 150), (8e-5, 2)])
def test_schedule_is_optaxs_at_every_step(lr, total):
    """one_cycle_linear against devo_tpu's optax schedule at every step of
    a short run (and the warmup's end, the middle and the end of the long
    one), within 1e-6 x lr: optax computes (init - end) * frac + end in
    f32, which cancels to a few f32 ulps of lr at the warmup's start."""
    steps = range(total + 3) if total < 1000 else [0, 1, 2399, 2400, 2401,
                                                    120_000, 239_999, 240_000]
    ours, theirs = one_cycle_linear(lr, total), jsched(lr, total)
    for k in steps:
        np.testing.assert_allclose(ours(k), float(theirs(k)), rtol=0,
                                   atol=1e-6 * lr, err_msg=f"step {k}")
    warm = max(int(total * 0.01), 1)
    np.testing.assert_allclose(ours(0), lr / 25, rtol=1e-12)
    np.testing.assert_allclose(ours(warm), lr, rtol=1e-12)
    np.testing.assert_allclose(ours(total), lr / 1e4, rtol=1e-12)


# --------------------------------------------------------------- optimizer

def _jax_step(tx):
    """devo_tpu's optimizer half of the train step (trainer.py:124-138),
    compiled as its jitted train step is."""
    def step(params, opt_state, grads, loss):
        nan_cnt = jax.tree.reduce(
            lambda a, b: a + b,
            jax.tree.map(lambda g: jnp.sum(~jnp.isfinite(g)), grads))
        grads = jax.tree.map(lambda g: jnp.where(jnp.isfinite(g), g, 0.0),
                             grads)
        nan = ~jnp.isfinite(loss)
        grads = jax.tree.map(lambda g: jnp.where(nan, 0.0, g), grads)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, nan_cnt
    return jax.jit(step)


def _jax_init(net, voxels):
    """devo_tpu's parameters for `net`, its init compiled (dispatched op by
    op it takes half a minute on the CPU)."""
    return jax.jit(net.init)(jax.random.PRNGKey(0), jnp.asarray(voxels[:1]),
                             jax.random.PRNGKey(1))["params"]


def test_optimizer_steps_match_optax():
    """Three steps with total_steps 200 (warmup 2, so the third step is
    past it) on the same gradient trees: a plain one, one whose global norm
    is far above 10 (clipped) with a NaN and an inf entry, and one with a
    non-finite loss (every gradient zeroed, the step still taken: AdamW's
    moments decay and its weight decay applies). The lr of each step and
    the parameters after each within 1e-6 of the largest entry (f32
    updates of lr size, the same operations in another order)."""
    params = _jax_init(JNet(**DIMS), make_inputs()[0])
    tx, sched = make_optimizer(lr=1e-3, total_steps=200)
    opt_state = tx.init(params)
    jstep = _jax_step(tx)
    tnet = EVONet(**DIMS)
    tnet.load_state_dict(jax_params_to_state_dict(jax.tree.map(np.asarray, params)))
    tr = Trainer(net=tnet, lr=1e-3, total_steps=200, device="cpu")

    rng = np.random.default_rng(0)
    leaves, treedef = jax.tree.flatten(params)
    for k, (scale, bad, loss) in enumerate([(1e-2, False, 1.0),
                                            (10.0, True, 2.0),
                                            (1e-2, False, float("nan"))]):
        g = [rng.standard_normal(np.shape(x)).astype(np.float32) * scale
             for x in leaves]
        if bad:
            g[0].flat[0] = np.nan
            g[-1].flat[-1] = np.inf
        jgrads = jax.tree.unflatten(treedef, [jnp.asarray(a) for a in g])
        assert abs(tr.lr() - float(sched(k))) <= 1e-6 * 1e-3
        params, opt_state, want_cnt = jstep(params, opt_state, jgrads,
                                            jnp.float32(loss))
        want_cnt = int(want_cnt)
        tg = jax_params_to_state_dict(jax.tree.map(np.asarray, jgrads))
        for name, p in tr.net.named_parameters():
            p.grad = tg[name].clone()
        got_cnt = tr.apply_gradients(torch.tensor(loss))
        assert int(got_cnt) == want_cnt == (2 if bad else 0)
        want = jax_params_to_state_dict(jax.tree.map(np.asarray, params))
        for name, p in tr.net.named_parameters():
            w = want[name].numpy()
            np.testing.assert_allclose(p.detach().numpy(), w, rtol=0,
                                       atol=1e-6 * max(np.abs(w).max(), 1.0),
                                       err_msg=f"step {k} {name}")
    assert tr.step == 3


# --------------------------------------------------------- train steps

def _batch(seeds):
    items = [make_inputs(s) for s in seeds]
    return {k: torch.from_numpy(np.stack([it[i] for it in items]))
            for i, k in enumerate(("voxels", "poses", "disps", "intrinsics"))}


def _trainer(**kw):
    net = EVONet(**DIMS)
    net.load_state_dict(random_state_dict(net, 0))
    return Trainer(net=net, total_steps=100, device="cpu", **SMALL, **kw)


def test_checkpoint_resume_is_the_uninterrupted_run_bit_for_bit(tmp_path):
    """Save after step 1, restore into a fresh trainer, take step 2: the
    parameters, the AdamW moments and the lr are the uninterrupted run's,
    bit for bit (model, optimizer, schedule and step are saved; the draws
    of a step depend on the step alone)."""
    b1, b2 = _batch([0]), _batch([1])
    a = _trainer()
    m1 = a.train_step(b1, structure_only=True)
    path = str(tmp_path / "ck.pth")
    a.save_checkpoint(path)
    m2 = a.train_step(b2)
    c = _trainer()
    assert c.load_checkpoint(path) == 1
    assert c.lr() == a.lr_at(1)
    m2c = c.train_step(b2)
    assert m2c == m2 and np.isfinite(m1["loss"]) and m2["grad_nonfinite"] == 0
    for (n, p), q in zip(a.net.named_parameters(), c.net.parameters()):
        assert torch.equal(p, q), n
    sa, sc = a.opt.state_dict()["state"], c.opt.state_dict()["state"]
    for i in sa:
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[i][key], sc[i][key])
    assert a.lr() == c.lr() and a.step == c.step == 2


def _ddp_worker(rank, port, out):
    torch.set_num_threads(2)        # the one process's count (_threads)
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=2)
    try:
        tr = _trainer()
        b = _batch([rank])
        m = tr.train_step(b)
        if rank == 0:
            torch.save({"metrics": m, "params": tr.net.state_dict(),
                        "grads": {n: p.grad for n, p in
                                  tr.net.named_parameters()}}, out)
    finally:
        torch.distributed.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_ddp_over_gloo_matches_one_process(tmp_path):
    """Two processes, one sample each, against one process with both: the
    same mean losses (all-reduced), the same gradient after the all-reduce,
    the clip and the non-finite rules, and parameters one AdamW step apart
    by less than that step's lr. Each process scales its losses by the
    global batch and the all-reduce sums, so that the heads' gradient clip
    acts as in the one process; the gradients differ in the order of one
    addition: within 1e-5 of each tensor's largest entry. AdamW's first
    step is lr x g / (|g| + eps), so a gradient entry near 0 may take either
    sign: the parameters are held to 2 x lr."""
    out = str(tmp_path / "ddp.pt")
    torch.multiprocessing.start_processes(
        _ddp_worker, args=(_free_port(), out), nprocs=2, join=True,
        start_method="spawn")
    ddp = torch.load(out, weights_only=False)
    one = _trainer()
    lr0 = one.lr()
    m = one.train_step(_batch([0, 1]))
    for k in ("loss", "flow", "pose", "scores"):
        np.testing.assert_allclose(ddp["metrics"][k], m[k], rtol=1e-6, err_msg=k)
    assert ddp["metrics"]["grad_nonfinite"] == m["grad_nonfinite"] == 0
    for name, p in one.net.named_parameters():
        g = p.grad.numpy()
        np.testing.assert_allclose(ddp["grads"][name].numpy(), g, rtol=0,
                                   atol=1e-5 * np.abs(g).max(), err_msg=name)
        np.testing.assert_allclose(ddp["params"][name].numpy(),
                                   p.detach().numpy(), rtol=0, atol=2 * lr0,
                                   err_msg=name)


def test_the_trainer_needs_a_device_or_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(net=EVONet(**DIMS))


# ------------------------------------------------------- the entry points

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("fake_tartan")
    make_tree(str(root), n=16)
    split = root / "val.txt"
    split.write_text("Env/Easy/P001\n")
    return root


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-m", "devo_tpu_torch.train"] + args,
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=600)


def test_train_cli_two_steps_checkpoint_and_resume(tree, tmp_path):
    """`python -m devo_tpu_torch.train --device cpu` on the fake tree: 2
    steps (the structure-only warmup, randaug), a checkpoint at step 2 and
    a validation round on the tree's scene; then a resume from that
    checkpoint to step 3."""
    common = ["--device", "cpu", "--datapath", str(tree), "--name", "t",
              "--iters", "3", "--n_frames", "5", "--crop_size", "48", "64",
              "--patches_per_image", "4", "--dim_inet", "32", "--dim_fnet",
              "16", "--dim", "8", "--randaug", "--ckpt_every", "2",
              "--ckpt_dir", str(tmp_path / "ck"), "--loader_workers", "1",
              "--eval_every", "2", "--val_split", str(tree / "val.txt"),
              "--val_max_frames", "6"]
    res = _run(common + ["--steps", "2"], tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    path = tmp_path / "ck" / "t" / "000002.pth"
    assert f"saved {path}" in res.stdout
    ck = torch.load(path, weights_only=True)
    assert ck["step"] == 2 and {"model", "optimizer", "scheduler"} <= set(ck)
    assert "[val @ 2]" in res.stdout and "val/ate_mean" in res.stdout
    assert "step 2:" in res.stdout and "grad_nonfinite 0" in res.stdout
    assert (tmp_path / "runs" / "t").is_dir()
    res = _run(common + ["--steps", "3", "--checkpoint", str(path)], tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "step 3:" in res.stdout and "step 1:" not in res.stdout


def test_train_cli_refuses_the_cpu_unasked(tree, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    res = _run(["--datapath", str(tree), "--steps", "1"], tmp_path)
    assert res.returncode != 0 and "CUDA" in res.stderr


VAL_CFG = dict(DIM_INET=32, DIM_FNET=16, DIM=8, PATCHES_PER_FRAME=8,
               MIXED_PRECISION=False, MOTION_PROBE_THRESH=-1.0,
               BUFFER_SIZE=64, MEM=16)


def _weights(path):
    net = EVONet(**DIMS)
    torch.save(random_state_dict(net, 0), path)
    return str(path)


def test_cli_tartanair_branch_on_the_fake_tree(tree, tmp_path):
    """`python -m devo_tpu_torch.eval.cli tartanair --device cpu` over the
    fake tree's scene: one trial with a finite ATE, its TUM dump and the
    results JSON."""
    out = tmp_path / "out"
    results = cli.main([
        "tartanair", "--datapath", str(tree), "--weights",
        _weights(tmp_path / "w.pth"), "--val_split", str(tree / "val.txt"),
        "--trials", "1", "--outdir", str(out), "--config_overrides",
        json.dumps(VAL_CFG), "--device", "cpu"])
    r = results["Env/Easy/P001"]
    assert np.isfinite(r["ate_cm"]) and len(r["ate_trials"]) == 1
    assert "_summary" in results
    assert (out / "tartanair_results.json").exists()
    assert np.loadtxt(out / "Env_Easy_P001_trial0.txt").shape == (16, 8)


def test_validation_records_a_failed_scene(tree, tmp_path):
    from devo_tpu_torch.runtime.config import EVAL_CONFIGS
    good = str(tree / "Env" / "Easy" / "evs_left" / "P001")
    bad = str(tmp_path / "Env" / "Easy" / "evs_left" / "P009")
    os.makedirs(bad)
    img = tmp_path / "Env" / "Easy" / "image_left" / "P009"
    os.makedirs(img)
    np.savetxt(img / "pose_left.txt", np.tile([0, 0, 0, 0, 0, 0, 1.0], (4, 1)))
    net = EVONet(**DIMS)
    m = validate_tartan_evs(
        random_state_dict(net, 0), [good, bad],
        cfg=EVAL_CONFIGS["tartanair"].replace(**VAL_CFG), max_frames=6,
        figures_dir=str(tmp_path / "figs"), step=3, device="cpu")
    assert m["val/Easy_evs_left_P009/failed"] == 1.0
    assert np.isfinite(m["val/Easy_evs_left_P001/ate"])
    assert m["val/ate_mean"] == m["val/Easy_evs_left_P001/ate"]
    assert len(list((tmp_path / "figs").glob("*step3.png"))) == 1


def test_warm_start_takes_the_matching_shapes():
    """A 3-channel network's weights into the event network: every weight
    but the 3-channel input convolutions (the encoders' and, as this source
    has a scorer, the scorer's first), whose initialization stays; 'module.'
    prefixes and update.lmbda as the loader handles them."""
    rgb = EVONet(bins=3, **DIMS)
    src = {("module." + k): v for k, v in random_state_dict(rgb, 1).items()}
    src["module.update.lmbda"] = torch.ones(1)
    evs = EVONet(**DIMS)
    init = {k: v.clone() for k, v in evs.state_dict().items()}
    kept = warm_start(src, evs, verbose=False)
    assert kept == ["patchify.fnet.conv1.weight", "patchify.inet.conv1.weight",
                    "patchify.scorer.scorer.0.weight"]
    for k, v in evs.state_dict().items():
        want = init[k] if k in kept else src["module." + k]
        assert torch.equal(v, want), k
