"""Training in the port (``repro_torch.train``, ``data``, the kernels'
backward) against the reference on the CPU, at smoke size.

The reference's ``Trainer.run`` fails on the CPU at its second step (the
jitted step's sharded outputs fed back in raise ``ShardingTypeError``), so
the oracles here are the surfaces of the reference that run:
``jax.value_and_grad(loss_and_metrics)``, ``build_train_step`` with the
state passed back through numpy after every step, the optimizers and the
pipeline. Tolerances:
  * pipeline batches: bit-equal (numpy on both sides);
  * losses: within 1e-5 relative at step 0, 1e-4 over 5 steps;
  * step-0 gradients: per leaf ||g_port - g_ref|| / ||g_ref|| <= 1e-4 (f32
    sums in another order); a leaf whose reference gradient is zero is zero;
  * params after 5 steps: atol 5e-5, rtol 1e-4 (the reference's own
    microbatch-test tolerance);
  * the grouped backward against ``jax.grad`` of ``ragged_dot``: atol 1e-5,
    rtol 1e-5.
The reference's four ``Trainer`` tests, which its ``Trainer`` cannot run,
are ported as tests of the port's ``Trainer``.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as M
from repro.configs import get_shape as jax_get_shape
from repro.configs import smoke_config as jax_smoke_config
from repro.data import SyntheticPipeline as JaxPipeline
from repro.launch.mesh import make_host_mesh as jax_host_mesh
from repro.optim import make_optimizer as jax_make_optimizer
from repro.optim import warmup_cosine as jax_warmup_cosine
from repro.train.losses import loss_and_metrics as jax_loss_and_metrics
from repro.train.losses import softmax_xent as jax_softmax_xent
from repro.train.train_step import build_train_step as jax_build_train_step
from repro.train.train_step import init_train_state as jax_init_train_state

from repro_torch import bridge
from repro_torch.configs import get_shape, smoke_config
from repro_torch.data import SyntheticPipeline, batch_to
from repro_torch.kernels import autograd, ops, ref
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.param import tree_leaves
from repro_torch.optim import constant, make_optimizer, warmup_cosine
from repro_torch.train import build_train_step, init_train_state
from repro_torch.train.losses import loss_and_metrics, softmax_xent
from repro_torch.train.train_step import value_and_grad
from repro_torch.train.trainer import Trainer, TrainerConfig

ROOT = Path(__file__).resolve().parents[1]
SHAPE = get_shape("train_4k").replace(seq_len=64, global_batch=4)
JSHAPE = jax_get_shape("train_4k").replace(seq_len=64, global_batch=4)
# (arch, layers): M3ViT-S smoke keeps its 4 layers (2 dense + 2 MoE), the LMs 2
GRAD_ARCHS = [("m3vit-small", 4), ("olmoe-1b-7b", 2), ("llama3-8b", 2)]
CPU = [torch.device("cpu")]


def _cfgs(arch, layers):
    return (jax_smoke_config(arch).replace(num_layers=layers),
            smoke_config(arch).replace(num_layers=layers))


def _np_tree(p):
    return jax.tree.map(np.asarray, p)


def _flat_np(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat_np(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree.detach() if isinstance(tree, torch.Tensor) else tree)}


def _assert_grads_close(got, want, rel=1e-4, noise=1e-6):
    """Per leaf ||got - want|| <= rel ||want||. A leaf whose gradient is
    zero in exact arithmetic (the attention's k bias: a constant added to
    every score of a row cancels in the softmax) holds rounding noise on
    both sides: where the reference's leaf is below ``noise`` times the
    global gradient norm, the port's must be too."""
    g, w = _flat_np(got), _flat_np(want)
    assert sorted(g) == sorted(w)
    total = np.sqrt(sum(np.sum(np.square(v.astype(np.float64))) for v in w.values()))
    worst = (0.0, "")
    for k in w:
        assert g[k].shape == w[k].shape, k
        ref_norm = np.linalg.norm(w[k].astype(np.float64))
        if ref_norm <= noise * total:
            assert np.linalg.norm(g[k].astype(np.float64)) <= noise * total, k
            continue
        worst = max(worst, (np.linalg.norm(g[k].astype(np.float64) - w[k]) / ref_norm, k))
    assert worst[0] <= rel, worst


# ---------------------------------------------------------------------------
# data and loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["m3vit-small", "llama3-8b", "olmoe-1b-7b"])
def test_pipeline_batches_bit_equal(arch):
    jcfg, tcfg = _cfgs(arch, 2)
    for seed, host, hosts in ((0, 0, 1), (3, 1, 2)):
        jp = JaxPipeline(jcfg, JSHAPE, seed=seed, host_id=host, num_hosts=hosts)
        tp = SyntheticPipeline(tcfg, SHAPE, seed=seed, host_id=host, num_hosts=hosts)
        for step in (0, 1, 7):
            a, b = jp.batch_for_step(step), tp.batch_for_step(step)
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                np.testing.assert_array_equal(a[k], b[k])


def test_shapes_match_reference():
    from repro.configs.base import SHAPES as JAX_SHAPES
    from repro_torch.configs import SHAPES

    assert sorted(SHAPES) == sorted(JAX_SHAPES)
    for name, shape in SHAPES.items():
        assert get_shape(name) == shape
        assert (shape.name, shape.kind, shape.seq_len, shape.global_batch) == (
            JAX_SHAPES[name].name, JAX_SHAPES[name].kind, JAX_SHAPES[name].seq_len,
            JAX_SHAPES[name].global_batch)
    with pytest.raises(KeyError):
        get_shape("train_1m")


def test_softmax_xent_matches_reference():
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((2, 5, 11))).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    for z in (0.0, 1e-4, 0.1):
        want = np.asarray(jax_softmax_xent(jnp.asarray(logits), jnp.asarray(labels), z))
        got = softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels), z)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.fixture(scope="module", params=GRAD_ARCHS, ids=[a for a, _ in GRAD_ARCHS])
def grad_case(request):
    """Reference params, one pipeline batch, and the reference's loss,
    metrics and gradients at step 0."""
    arch, layers = request.param
    jcfg, tcfg = _cfgs(arch, layers)
    params = M.init_model_params(jcfg, jax.random.PRNGKey(0))
    batch = JaxPipeline(jcfg, JSHAPE, seed=0).batch_for_step(0)
    (loss, metrics), grads = jax.value_and_grad(jax_loss_and_metrics, has_aux=True)(
        params, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    return {"jcfg": jcfg, "tcfg": tcfg, "params": _np_tree(params), "batch": batch,
            "loss": float(loss), "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": _np_tree(grads)}


def test_loss_and_metrics_match_reference(grad_case):
    tp = bridge.params_from_numpy(grad_case["params"], "cpu")
    with torch.no_grad():
        loss, metrics = loss_and_metrics(tp, grad_case["tcfg"], batch_to(grad_case["batch"], "cpu"))
    np.testing.assert_allclose(float(loss), grad_case["loss"], rtol=1e-5)
    for k, v in grad_case["metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), v, rtol=1e-5, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("remat", [False, True])
def test_step0_gradients_match_reference(grad_case, remat):
    tp = bridge.params_from_numpy(grad_case["params"], "cpu")
    grads, metrics = value_and_grad(tp, grad_case["tcfg"].replace(remat=remat),
                                    batch_to(grad_case["batch"], "cpu"))
    np.testing.assert_allclose(float(metrics["loss"]), grad_case["loss"], rtol=1e-5)
    _assert_grads_close(grads, grad_case["grads"])


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,layers", [("m3vit-small", 4), ("olmoe-1b-7b", 2),
                                         ("falcon-mamba-7b", 2)])
def test_five_steps_match_reference_train_step(arch, layers):
    """Oracle (a): the reference's ``build_train_step`` with its state passed
    back through numpy after every step."""
    jcfg, tcfg = _cfgs(arch, layers)
    params = M.init_model_params(jcfg, jax.random.PRNGKey(0))
    jopt = jax_make_optimizer("adamw", jax_warmup_cosine(1e-3, 1, 5))
    mesh = jax_host_mesh()
    with mesh:
        jstate = jax_init_train_state(jcfg, jopt, jax.random.PRNGKey(0))
        jstate = jstate._replace(params=params)
        jstep = jax_build_train_step(jcfg, JSHAPE, mesh, jopt, donate=False)
    topt = make_optimizer("adamw", warmup_cosine(1e-3, 1, 5))
    tstate = init_train_state(tcfg, topt, params=bridge.params_from_numpy(_np_tree(params), "cpu"))
    tstep = build_train_step(tcfg, SHAPE, make_host_mesh(devices=CPU), topt)
    jpipe = JaxPipeline(jcfg, JSHAPE, seed=0)
    for step in range(5):
        batch = jpipe.batch_for_step(step)
        with mesh:
            jstate, jm = jstep(jax.tree.map(jnp.asarray, jax.tree.map(np.asarray, jstate)),
                               {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tm = tstep(tstate, batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    assert int(tstate.step) == 5
    want, got = _flat_np(_np_tree(jstate.params)), _flat_np(tstate.params)
    start = _flat_np(_np_tree(params))
    lr_sum = sum(float(np.asarray(jax_warmup_cosine(1e-3, 1, 5)(jnp.asarray(s))))
                 for s in range(5))
    for k in want:
        if k.endswith("attn/bk"):
            # its gradient is zero in exact arithmetic (see _assert_grads_close)
            # and rounding noise in both packages, which AdamW turns into steps
            # of up to lr each way: each side moved no further than that
            for side in (got[k], want[k]):
                assert np.abs(side - start[k]).max() <= 1.01 * lr_sum, k
            continue
        np.testing.assert_allclose(got[k], want[k], atol=5e-5, rtol=1e-4, err_msg=k)


def test_microbatch_accumulation_matches_full_batch():
    """The reference's test on the port: two microbatches of 2 give the
    step of one batch of 4."""
    _, cfg = _cfgs("llama3-8b", 2)
    cfg = cfg.replace(remat=False, microbatch_size=0)
    opt = make_optimizer("adamw", constant(1e-3))
    batch = SyntheticPipeline(cfg, SHAPE, seed=0).batch_for_step(0)
    s0 = init_train_state(cfg, opt, 0, device="cpu")
    full, _ = build_train_step(cfg, SHAPE, None, opt)(s0, batch)
    micro, _ = build_train_step(cfg.replace(microbatch_size=2), SHAPE, None, opt)(s0, batch)
    for a, b in zip(tree_leaves(full.params), tree_leaves(micro.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-5, rtol=1e-4)


# the reference's pod branch (``_pod_compressed_grads``: a shard_map over the
# pod axis) on two fake CPU devices, in a process of its own; it writes the
# params it starts from, the batch, its metrics, the updated params, each
# pod's gradients (``jax.value_and_grad(loss_and_metrics)`` on its half) and
# their coding in the branch's per-leaf arithmetic, its collectives written
# out over the two pods (pmax: a max; psum of int32: an exact sum)
_POD_ORACLE = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_shape, smoke_config
from repro.data import SyntheticPipeline
from repro.optim import constant, make_optimizer
from repro.train.losses import loss_and_metrics
from repro.train.train_step import build_train_step, init_train_state

cfg = smoke_config("llama3-8b").replace(num_layers=2)
shape = get_shape("train_4k").replace(seq_len=64, global_batch=4)
mesh = jax.make_mesh((2, 1, 1), ("pod", "data", "model"))
opt = make_optimizer("adamw", constant(1e-3))
batch = SyntheticPipeline(cfg, shape, seed=0).batch_for_step(0)
with mesh:
    state = init_train_state(cfg, opt, jax.random.PRNGKey(0), grad_compress=True)
    step = build_train_step(cfg, shape, mesh, opt, grad_compress=True, donate=False)
    new, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()})

def flat(tree, prefix):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {prefix + "/".join(str(k.key) for k in path): np.asarray(v) for path, v in leaves}

grad = jax.jit(jax.value_and_grad(lambda p, b: loss_and_metrics(p, cfg, b), has_aux=True))
pod_grads = [grad(state.params, {k: jnp.asarray(v[2 * i:2 * i + 2]) for k, v in batch.items()})[1]
             for i in range(2)]

@jax.jit
def coding(g0, g1):
    def one(a, b):
        scale = jnp.maximum(jnp.max(jnp.abs(a)) / 127.0, jnp.max(jnp.abs(b)) / 127.0) + 1e-30
        s = sum(jnp.clip(jnp.round(g / scale), -127, 127).astype(jnp.int32) for g in (a, b))
        return s, s.astype(jnp.float32) * (scale / 2)
    out = jax.tree.map(one, g0, g1)
    return (jax.tree.map(lambda o: o[0], out, is_leaf=lambda x: isinstance(x, tuple)),
            jax.tree.map(lambda o: o[1], out, is_leaf=lambda x: isinstance(x, tuple)))

sums, dec = coding(*pod_grads)
np.savez(sys.argv[1], **flat(state.params, "p0:"), **flat(new.params, "p1:"),
         **flat(pod_grads[0], "g0:"), **flat(pod_grads[1], "g1:"), **flat(sums, "s:"),
         **flat(dec, "d:"),
         **{"m:" + k: np.asarray(v) for k, v in metrics.items()},
         **{"b:" + k: v for k, v in batch.items()})
"""


def _unflat(arrays: dict, prefix: str) -> dict:
    out: dict = {}
    for key, v in arrays.items():
        if key.startswith(prefix):
            *path, leaf = key[len(prefix):].split("/")
            node = out
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
    return out


def _pod_mesh(n):
    from repro_torch.launch.mesh import Mesh

    return Mesh(np.array(CPU * n, dtype=object).reshape(n, 1, 1), ("pod", "data", "model"))


def test_pod_compressed_grads_match_reference(tmp_path):
    """Two pods with ``grad_compress``. (1) Fed the reference's own per-pod
    gradients (``jax.value_and_grad(loss_and_metrics)`` on each half of the
    batch), ``optim.pod_compress`` / ``pod_decompress`` give the reference's
    int32 sums and decoded gradients bit for bit. (2) The whole step against
    the reference's branch run on two fake CPU devices (a subprocess): loss
    and grad norm within rtol 1e-4, every updated param within atol 5e-5,
    rtol 1e-4 (the five-step test's tolerance; the packages' gradients round
    apart, so a code may differ by one)."""
    from repro_torch.optim import pod_compress, pod_decompress

    out = tmp_path / "pod.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=2",
               JAX_PLATFORMS="cpu", REPRO_PALLAS="ref",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    subprocess.run([sys.executable, "-c", _POD_ORACLE, str(out)], check=True, env=env,
                   timeout=300)
    arrays = dict(np.load(out))
    p0, p1 = _unflat(arrays, "p0:"), _unflat(arrays, "p1:")
    batch = {k[2:]: v for k, v in arrays.items() if k.startswith("b:")}
    _, tcfg = _cfgs("llama3-8b", 2)

    # (1) the coding, on the reference's per-pod gradients
    pod_grads = [_flat_np(_unflat(arrays, f"g{i}:")) for i in range(2)]
    want_sums, want_dec = _flat_np(_unflat(arrays, "s:")), _flat_np(_unflat(arrays, "d:"))
    sums, scales = pod_compress([{k: torch.tensor(v) for k, v in g.items()}
                                 for g in pod_grads])
    dec = pod_decompress(sums, scales, 2)
    for k in want_sums:
        assert sums[k].dtype == torch.int32
        np.testing.assert_array_equal(sums[k].numpy(), want_sums[k], err_msg=k)
        np.testing.assert_array_equal(dec[k].numpy(), want_dec[k], err_msg=k)

    # (2) the whole step
    opt = make_optimizer("adamw", constant(1e-3))
    state = init_train_state(tcfg, opt, params=bridge.params_from_numpy(p0, "cpu"),
                             grad_compress=True)
    new, metrics = build_train_step(tcfg, SHAPE, _pod_mesh(2), opt, grad_compress=True)(
        state, batch)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[k]), float(arrays["m:" + k]), rtol=1e-4,
                                   err_msg=k)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(new.compress.residual),
                                                 tree_leaves(state.compress.residual)))
    want, got = _flat_np(p1), _flat_np(new.params)
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=5e-5, rtol=1e-4, err_msg=k)


def test_pod_step_without_compress_is_the_single_pod_step():
    """Without ``grad_compress`` the pod axis is data parallelism: the step
    on a 2-pod mesh is the step without a mesh, bit for bit; the metrics too."""
    _, cfg = _cfgs("llama3-8b", 2)
    opt = make_optimizer("adamw", constant(1e-3))
    batch = SyntheticPipeline(cfg, SHAPE, seed=0).batch_for_step(0)
    s0 = init_train_state(cfg, opt, 0, device="cpu")
    a, ma = build_train_step(cfg, SHAPE, _pod_mesh(2), opt)(s0, batch)
    b, mb = build_train_step(cfg, SHAPE, None, opt)(s0, batch)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)))
    assert all(torch.equal(ma[k], mb[k]) for k in mb)


def test_pod_step_is_its_written_out_composition():
    """The pod step on the port alone: two single-pod gradient calls on the
    halves, the coding, clip and AdamW, bit for bit (what chip_smoke.py's
    phase 13 holds on the card); the metrics the mean over the pods."""
    from repro_torch.optim import clip_by_global_norm, pod_compress, pod_decompress

    _, cfg = _cfgs("llama3-8b", 2)
    opt = make_optimizer("adamw", constant(1e-3))
    batch = batch_to(SyntheticPipeline(cfg, SHAPE, seed=0).batch_for_step(0), "cpu")
    s0 = init_train_state(cfg, opt, 0, device="cpu", grad_compress=True)
    new, metrics = build_train_step(cfg, SHAPE, _pod_mesh(2), opt, grad_compress=True)(s0, batch)
    per = [value_and_grad(s0.params, cfg, {k: v[2 * i:2 * i + 2] for k, v in batch.items()})
           for i in range(2)]
    grads = pod_decompress(*pod_compress([g for g, _ in per]), 2)
    grads, norm = clip_by_global_norm(grads, 1.0)
    want, _ = opt.update(grads, s0.opt_state, s0.params, s0.step)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(new.params), tree_leaves(want)))
    assert torch.equal(metrics["grad_norm"], norm)
    assert torch.equal(metrics["loss"], (per[0][1]["loss"] + per[1][1]["loss"]) / 2)
    with pytest.raises(ValueError, match="pods"):
        build_train_step(cfg, SHAPE.replace(global_batch=3), _pod_mesh(2), opt,
                         grad_compress=True)


# ---------------------------------------------------------------------------
# the kernels' backward
# ---------------------------------------------------------------------------

SIZES = [5, 0, 9, 2]  # one group empty


def _grouped_operands(seed=0, Din=12, Dout=10):
    rng = np.random.default_rng(seed)
    T = sum(SIZES)
    return (rng.standard_normal((T, Din)).astype(np.float32),
            rng.standard_normal((len(SIZES), Din, Dout)).astype(np.float32),
            rng.standard_normal((T, Dout)).astype(np.float32),
            np.asarray(SIZES, np.int32))


def _ragged_dot_grads(x, w, dy, sizes):
    f = lambda x, w: jnp.sum(jax.lax.ragged_dot(x, w, jnp.asarray(sizes)) * dy)  # noqa: E731
    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))]


def test_grouped_backward_matches_ragged_dot():
    x, w, dy, sizes = _grouped_operands()
    jdx, jdw = _ragged_dot_grads(x, w, dy, sizes)
    gs = torch.from_numpy(sizes)
    np.testing.assert_allclose(ref.grouped_wgrad_ref(torch.from_numpy(x), torch.from_numpy(dy),
                                                     gs).numpy(), jdw, atol=1e-5, rtol=1e-5)
    assert not ref.grouped_wgrad_ref(torch.from_numpy(x), torch.from_numpy(dy), gs)[1].any()
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = ops.grouped_matmul(xt, wt, gs)
    assert y.grad_fn is not None and "GroupedMatmul" in type(y.grad_fn).__name__
    y.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(xt.grad.numpy(), jdx, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), jdw, atol=1e-5, rtol=1e-5)


def test_grouped_backward_matches_ragged_dot_at_skewed_routing():
    """The grouped backward (forward, dx, dw through the plain versions)
    against ``jax.grad`` of ``ragged_dot`` at M3ViT-S's training routing
    scaled down 64-fold (16 experts, one empty, one ~4.3x the mean) with a
    single-row group: atol 1e-5, rtol 1e-5."""
    sizes = np.asarray([13, 21, 23, 0, 13, 30, 12, 105, 30, 23, 18, 21, 24, 16, 13, 1],
                       np.int32)
    rng = np.random.default_rng(7)
    T, Din, Dout = int(sizes.sum()), 24, 16
    x = rng.standard_normal((T, Din)).astype(np.float32)
    w = rng.standard_normal((len(sizes), Din, Dout)).astype(np.float32)
    dy = rng.standard_normal((T, Dout)).astype(np.float32)
    jdx, jdw = _ragged_dot_grads(x, w, dy, sizes)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    ops.grouped_matmul(xt, wt, torch.from_numpy(sizes)).backward(torch.from_numpy(dy))
    np.testing.assert_allclose(xt.grad.numpy(), jdx, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), jdw, atol=1e-5, rtol=1e-5)
    assert not wt.grad[3].any()


@pytest.mark.parametrize("act,glu", [("silu", True), ("gelu", False)])
def test_grouped_mlp_ref_matches_reference(act, glu):
    """``ref.grouped_mlp_ref`` against ``repro.kernels.ref.grouped_mlp_ref``
    (one group empty): atol 1e-5, rtol 1e-5."""
    from repro.kernels.ref import grouped_mlp_ref as jax_grouped_mlp_ref

    rng = np.random.default_rng(5)
    T, D, ff = sum(SIZES), 12, 6
    x = rng.standard_normal((T, D)).astype(np.float32)
    wi = rng.standard_normal((len(SIZES), D, 2 * ff if glu else ff)).astype(np.float32)
    wo = rng.standard_normal((len(SIZES), ff, D)).astype(np.float32)
    sizes = np.asarray(SIZES, np.int32)
    want = np.asarray(jax_grouped_mlp_ref(jnp.asarray(x), jnp.asarray(wi), jnp.asarray(wo),
                                          jnp.asarray(sizes), act=act, glu=glu))
    got = ref.grouped_mlp_ref(torch.from_numpy(x), torch.from_numpy(wi), torch.from_numpy(wo),
                              torch.from_numpy(sizes), act=act, glu=glu)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


class _OnCard(torch.Tensor):
    """A CPU tensor that ``ops`` takes for a CUDA one (its branches read
    ``is_cuda``); the kernel entries are monkeypatched, nothing launches."""

    @property
    def is_cuda(self):
        return True


def _card(t):
    return torch.Tensor._make_subclass(_OnCard, t, t.requires_grad)


def test_grouped_backward_on_the_card_runs_the_kernels(monkeypatch):
    """On the card: forward and dx through the grouped kernel (dx on the
    transposed stack), dw through the weight-gradient kernel."""
    calls = []

    def gmm(x, w, sizes, **kw):
        calls.append(("gmm", tuple(w.shape)))
        return ref.grouped_matmul_ref(x.as_subclass(torch.Tensor), w.as_subclass(torch.Tensor),
                                      sizes.as_subclass(torch.Tensor))

    def wgrad(x, dy, sizes):
        calls.append(("wgrad", tuple(x.shape), tuple(dy.shape)))
        return ref.grouped_wgrad_ref(x.as_subclass(torch.Tensor), dy.as_subclass(torch.Tensor),
                                     sizes.as_subclass(torch.Tensor))

    monkeypatch.setattr(ops, "_gmm_kernel", gmm)
    monkeypatch.setattr(ops, "_wgrad_kernel", wgrad)
    x, w, dy, sizes = _grouped_operands(1)
    jdx, jdw = _ragged_dot_grads(x, w, dy, sizes)
    xt = _card(torch.from_numpy(x)).requires_grad_()
    wt = _card(torch.from_numpy(w)).requires_grad_()
    y = ops.grouped_matmul(xt, wt, _card(torch.from_numpy(sizes)))
    y.backward(_card(torch.from_numpy(dy)))
    assert calls == [("gmm", (4, 12, 10)), ("gmm", (4, 10, 12)), ("wgrad", (16, 12), (16, 10))]
    np.testing.assert_allclose(xt.grad.as_subclass(torch.Tensor).numpy(), jdx, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(wt.grad.as_subclass(torch.Tensor).numpy(), jdw, atol=1e-5, rtol=1e-5)


def test_recompute_backward_is_the_plain_versions_gradient():
    """Attention (the vision 4-bit case and the causal fp case) and RMSNorm
    under grad: a ``Recompute`` node whose gradient is autograd's of the
    plain version."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 9, 2, 8)).astype(np.float32))
               for _ in range(3))
    g = torch.from_numpy(rng.standard_normal((2, 9, 2, 8)).astype(np.float32))
    for kw in (dict(causal=False, quant_bits=4), dict(causal=True, quant_bits=0)):
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        out = ops.attention(*ins, **kw)
        assert "Recompute" in type(out.grad_fn).__name__
        got = torch.autograd.grad(out, ins, g)
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(ref.flash_attention_ref(*ins, **kw), ins, g)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    x = torch.from_numpy(rng.standard_normal((5, 8)).astype(np.float32)).requires_grad_()
    gamma = torch.from_numpy(rng.standard_normal(8).astype(np.float32)).requires_grad_()
    got = torch.autograd.grad(ops.rmsnorm(x, gamma), (x, gamma), torch.ones(5, 8))
    want = torch.autograd.grad(ref.rmsnorm_ref(x, gamma), (x, gamma), torch.ones(5, 8))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_kernels_without_backward_raise_on_the_card(monkeypatch):
    """On the card a kernel with no backward (the integer ones) raises under
    grad (an output with no grad_fn would freeze the weights behind it);
    under no_grad it launches. The selective scan has a backward
    (tests/test_torch_scan_grad.py)."""
    launched = []
    monkeypatch.setattr(ops, "_int8_kernel", lambda *a: launched.append("int8") or a[0].float())
    monkeypatch.setattr(ops, "_gmm_kernel", lambda *a, **k: launched.append("gmm") or a[0].float())
    x_q = _card(torch.ones((2, 4), dtype=torch.int8))
    w_q = _card(torch.ones((4, 3), dtype=torch.int8))
    scale = _card(torch.ones(3)).requires_grad_()
    with pytest.raises(NotImplementedError, match="int8_matmul"):
        ops.int8_matmul(x_q, w_q, 0.5, scale)
    wq = _card(torch.ones((2, 4, 3), dtype=torch.int8))
    gs = _card(torch.tensor([1, 1], dtype=torch.int32))
    xf = _card(torch.ones((2, 4))).requires_grad_()
    with pytest.raises(NotImplementedError, match="grouped_matmul"):
        ops.grouped_matmul(xf, wq, gs, w_scale=_card(torch.ones((2, 3))),
                           a_scale=_card(torch.tensor(0.1)))
    with torch.no_grad():
        ops.int8_matmul(x_q, w_q, 0.5, scale)
        ops.grouped_matmul(xf, wq, gs, w_scale=_card(torch.ones((2, 3))),
                           a_scale=_card(torch.tensor(0.1)))
    assert launched == ["int8", "gmm"]
    with pytest.raises(NotImplementedError, match="no backward"):
        autograd.no_backward("k", torch.ones(1, requires_grad=True))
    autograd.no_backward("k", torch.ones(1))


# ---------------------------------------------------------------------------
# the Trainer: the reference's four Trainer tests, on the port
# ---------------------------------------------------------------------------

def _mini_cfg(arch="llama3-8b"):
    return smoke_config(arch).replace(num_layers=2, remat=False)


def _trainer(tc, cfg=None):
    return Trainer(cfg or _mini_cfg(), SHAPE, make_host_mesh(devices=CPU), tc)


def test_loss_decreases_on_bigram_task():
    tr = _trainer(TrainerConfig(total_steps=30, lr=5e-3, warmup_steps=5, log_every=100,
                                device="cpu"))
    tr.run()
    first = np.mean([h["loss"] for h in tr.history[:5]])
    last = np.mean([h["loss"] for h in tr.history[-5:]])
    assert last < first - 0.2, (first, last)


def test_checkpoint_resume_is_deterministic(tmp_path):
    """10 steps straight equal 5, a checkpoint, a fresh Trainer restoring
    it and 5 more: every param and optimizer leaf bit for bit."""
    def tc(total, d, every):
        return TrainerConfig(total_steps=total, lr=1e-3, log_every=100, device="cpu",
                             checkpoint_dir=str(tmp_path / d), checkpoint_every=every)

    state_a = _trainer(tc(10, "a", 100)).run()
    _trainer(tc(5, "b", 5)).run()
    state_b = _trainer(tc(10, "b", 100)).run()  # restores step 5, runs 5 more
    assert int(state_a.step) == int(state_b.step) == 10
    for a, b in zip(tree_leaves({"p": state_a.params, "o": state_a.opt_state}),
                    tree_leaves({"p": state_b.params, "o": state_b.opt_state})):
        assert torch.equal(a, b)


def test_preemption_drains_with_checkpoint(tmp_path):
    tr = _trainer(TrainerConfig(total_steps=50, lr=1e-3, log_every=100, device="cpu",
                                checkpoint_dir=str(tmp_path), checkpoint_every=1000))

    def on_step(step, rec):
        if step == 3:
            tr.guard.request()  # a simulated SIGTERM

    state = tr.run(on_step=on_step)
    assert int(state.step) == 4  # drained right after the preemption request
    assert tr.ckpt.latest_step() == 4  # with a checkpoint written on the drain


def test_grad_compression_trains():
    tr = _trainer(TrainerConfig(total_steps=20, lr=5e-3, warmup_steps=5, log_every=100,
                                grad_compress=True, device="cpu"))
    state = tr.run()
    assert state.compress is not None
    first = np.mean([h["loss"] for h in tr.history[:5]])
    last = np.mean([h["loss"] for h in tr.history[-5:]])
    assert last < first - 0.1


def test_trainer_records_step_times_and_logs(capsys):
    tr = _trainer(TrainerConfig(total_steps=2, lr=1e-3, log_every=1, device="cpu"),
                  cfg=smoke_config("m3vit-small"))
    tr.run()
    assert [h["step"] for h in tr.history] == [0, 1]
    assert all(h["step_time_s"] > 0 for h in tr.history)
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "step     1 loss" in out


def test_launch_train_smoke_on_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "m3vit-small",
         "--smoke", "--device", "cpu", "--steps", "3", "--batch", "4",
         "--ckpt", str(tmp_path), "--ckpt-every", "2"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "finished at step 3; final loss" in out.stdout
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000002"]
