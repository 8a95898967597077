"""Helpers of the LiDAR detectors' parity tests (tests/test_torch_
centerpoint.py, _sassd.py, _point_rcnn.py, _parta2.py, _ssd3d.py,
_mvx.py, _votenet.py): seeded point
clouds, the relative L2, and one training step of a JAX module against
the port's `TrainStep` by the rules of tests/test_torch_train_step.py."""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from dfm_tpu.runtime.schedule import liga_schedule as jax_schedule
from dfm_tpu.runtime.train import (create_train_state, make_optimizer as
                                   jax_make_optimizer, make_train_step)
from dfm_tpu_torch.runtime.schedule import liga_schedule
from dfm_tpu_torch.runtime.train import TrainStep, make_optimizer
from dfm_tpu_torch.utils import weights as W

from test_torch_dfm_full_train import FAST_COMPILE
from test_torch_train_step import (GRAD_REL_L2, GRAD_REL_L2_ALL, LOSS_RTOL,
                                   LR, PARAM_ATOL, STATS_ATOL, RecordGrads)

torch.set_num_threads(1)    # from import on; the workers share the cores

RANGE = (0.0, -8.0, -2.0, 16.0, 8.0, 1.2)
ZERO_GRAD = 1e-5     # of the whole gradient's norm: a gradient that is 0


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def t(x):
    return torch.from_numpy(np.array(x))


def cloud(b, p, seed, pcr=RANGE, clusters=8, per=40, spread=0.05):
    """(B, P, 3) float32 points uniform in `pcr` (half a metre past it)
    with `clusters` dense blobs a sample (standard deviation `spread`
    metres), and a mask with ~5 % dropped."""
    rng = np.random.RandomState(seed)
    lo, hi = np.array(pcr[:3]), np.array(pcr[3:])
    pts = rng.uniform(lo - 0.5, hi + 0.5, (b, p, 3))
    for i in range(b):
        for c in range(clusters):
            s = p - (c + 1) * per
            pts[i, s:s + per] = rng.uniform(lo + 1, hi - 1) + \
                spread * rng.randn(per, 3)
    return pts.astype(np.float32), rng.rand(b, p) > 0.05


def boxes_on_points(pts, g, seed, sizes=((3.9, 1.6, 1.56), (0.8, 0.6, 1.73),
                                         (1.76, 0.6, 1.73))):
    """(B, G, 7) bottom-centre gt boxes, labels, mask: box j of sample i
    centred on a cluster point (so points lie inside), class j % 3 at its
    mean size, a seeded yaw; the last row padded."""
    rng = np.random.RandomState(seed)
    b = pts.shape[0]
    boxes = np.zeros((b, g, 7), np.float32)
    labels = np.zeros((b, g), np.int64)
    mask = np.zeros((b, g), bool)
    for i in range(b):
        for j in range(g - 1):
            c = j % 3
            ctr = pts[i, -(j + 1) * 40 + 5]
            boxes[i, j] = (ctr[0], ctr[1], ctr[2] - sizes[c][2] / 2,
                           *sizes[c], rng.uniform(-np.pi, np.pi))
            labels[i, j] = c
            mask[i, j] = True
    boxes[:, -1] = (6.0, 1.0, -1.0, 4.0, 1.7, 1.5, 0.2)    # a padded row
    return boxes, labels, mask


def _jax_step(jm, j_loss, variables, key_map, jbatch, model_args,
              compiler_options=FAST_COMPILE):
    """JAX's compiled step -> (metrics, gradients, state after) in the
    port's keys."""
    tx = optax.chain(RecordGrads.make(),
                     jax_make_optimizer(jax_schedule(**LR)))
    state = create_train_state(variables, tx)
    step = make_train_step(jm, lambda o, bt, r: j_loss(o, bt), donate=False,
                           model_args_fn=model_args)
    key = jax.random.PRNGKey(0)
    new, metrics = step.lower(state, jbatch, key).compile(
        compiler_options=compiler_options)(state, jbatch, key)
    grads = W.state_dict_from_jax({'params': jax.device_get(
        new.opt_state[0])}, key_map)
    after = W.state_dict_from_jax(jax.device_get(
        {'params': new.params, 'batch_stats': new.batch_stats}), key_map)
    return {k: float(v) for k, v in metrics.items()}, grads, after


def _port_step(port, port_inputs):
    ts = TrainStep(port, make_optimizer(port), liga_schedule(**LR))
    with torch.backends.mkldnn.flags(enabled=False):
        total, losses = ts.forward(*port_inputs)
        ts.backward(total)
    ts.reduce()
    grads = {n: p.grad.clone() for n, p in port.named_parameters()}
    norm = float(ts.update())
    return dict(loss=float(total.detach()), grad_norm=norm,
                **{k: float(v.detach()) for k, v in losses.items()}), grads


def gt_on_proposals(batch, outputs, rows, seed):
    """`batch` with gt rows `rows` of each sample moved onto that sample's
    first valid proposals of `outputs` (the train-mode forward's), each
    shifted by up to 3 % of its size and turned by up to 0.03 rad: the
    RoIs' IoU with them stays above the RCNN's positive thresholds, so
    that its regression term and gradients are live."""
    rng = np.random.RandomState(seed)
    out = {k: np.array(v) for k, v in batch.items()}
    for i, (props, valid, labels) in enumerate(zip(
            outputs['proposals'], outputs['prop_mask'],
            outputs['prop_labels'])):
        picks = np.flatnonzero(valid)[:len(rows)]
        assert len(picks) == len(rows)
        for r, j in zip(rows, picks):
            box = props[j].astype(np.float64)
            box[:3] += rng.uniform(-0.03, 0.03, 3) * box[3:6]
            box[6] += rng.uniform(-0.03, 0.03)
            out['gt_boxes'][i, r] = box
            out['gt_labels'][i, r] = labels[j]
            out['gt_mask'][i, r] = True
    return out


def _to64(x):
    return x.astype(np.float64) if np.issubdtype(np.asarray(x).dtype,
                                                  np.floating) else x


def check_step(jm, j_loss, variables, key_map, port, jbatch, model_args,
               port_inputs, live=(), f64=None, probe=False, rounding=(),
               float32=True, compiler_options=FAST_COMPILE):
    """One JAX `make_train_step` of `jm` (loss `j_loss(outputs, batch)`) and
    one port `TrainStep` of `port` (loaded with the same weights) on the
    same batch: the loss terms (rtol LOSS_RTOL), each parameter's
    gradient (relative L2 GRAD_REL_L2; a gradient that is 0, as a bias's
    ahead of a train-mode BatchNorm, within ZERO_GRAD of the whole
    vector's norm on both sides) and the whole vector's
    (GRAD_REL_L2_ALL), the BatchNorm statistics after the step (atol
    STATS_ATOL) and the parameters after the update within what the two
    gradients explain + PARAM_ATOL. Every parameter whose name starts
    with one of `live` must have a gradient that is not 0. JAX's step is
    compiled with `compiler_options` (FAST_COMPILE: XLA's CPU backend
    without LLVM's costly passes; {} for XLA's defaults).

    `f64` = (the JAX module in float64, a function of the port model ->
    its float64 inputs), for a model whose float32 rounding JAX's own
    step amplifies beyond those limits: JAX's step then runs in float64
    (under `jax.enable_x64`) and is the reference. The port's float64
    step agrees with it within 1e-6 (loss terms rtol, gradients relative
    L2, statistics atol), and the port's float32 step is held to it by
    the rules above. With `probe`, for a model whose float32 steps round
    far from their float64 ones (discrete choices on rounded values: FPS
    over votes, ball groups, max pooling over groups of near-equal
    features), JAX's float32 step of `jm` runs too: a loss term and the
    whole gradient vector may then also lie as far from the float64 step
    as JAX's own float32 step does; each parameter stays within
    GRAD_REL_L2 and each statistic within STATS_ATOL, but for those whose
    names start with one of `rounding` (with `probe`): each of them must
    lie beyond that limit in JAX's own float32 step (a gradient's relative
    L2, a statistic's largest error), and the port's float32 step no
    farther than JAX's (the float64 port's 1e-6 holds them as every
    other).

    `float32=False` (with `f64`, not `probe`): the float64 pair alone, for
    weights where the float32 steps of both packages lie beyond these
    rules from the float64 step.

    The steps run in threads: JAX's compiles beside the port's steps.
    Returns (the reference step's metrics, the worst parameter's gradient
    gap outside `rounding`, the whole vector's; None for both without
    `float32`)."""
    assert f64 is not None or (float32 and not probe)
    assert probe or not rounding
    assert float32 or not probe
    if f64 is not None:
        port64 = type(port)(port.cfg, dtype=torch.float64).double()
        port64.load_state_dict(port.state_dict())

    def jax64():
        with jax.enable_x64():
            return _jax_step(
                f64[0], j_loss, jax.tree.map(_to64, variables), key_map,
                jax.tree.map(lambda x: jnp.asarray(_to64(np.asarray(x))),
                             jbatch), model_args, compiler_options)

    # oneDNN off around all the steps: each port step turns it off and
    # back to the state it found
    with torch.backends.mkldnn.flags(enabled=False), \
            concurrent.futures.ThreadPoolExecutor(3) as pool:
        j32 = pool.submit(_jax_step, jm, j_loss, variables, key_map, jbatch,
                          model_args, compiler_options) \
            if f64 is None or probe else None
        if f64 is not None:
            j64 = pool.submit(jax64)
            p64 = pool.submit(_port_step, port64, f64[1](port64))
        if float32:
            got, grads = _port_step(port, port_inputs)
        if j32 is not None:
            metrics32, grads32, after32 = j32.result()
            metrics, jgrads, after = metrics32, grads32, after32
        if f64 is not None:
            (metrics, jgrads, after), (got64, grads64) = (j64.result(),
                                                          p64.result())
    if f64 is not None:
        assert set(got64) == set(metrics)
        for k, v in got64.items():
            np.testing.assert_allclose(v, metrics[k], rtol=1e-6, atol=1e-9,
                                       err_msg=k)
        whole64 = np.linalg.norm(np.concatenate(
            [x.numpy().ravel() for x in jgrads.values()]))
        for n, g in grads64.items():
            want = jgrads[n].numpy()
            assert np.linalg.norm(g.numpy() - want) <= 1e-6 * max(
                np.linalg.norm(want), ZERO_GRAD * whole64), n
        for n, x in port64.state_dict().items():
            if n.endswith(('running_mean', 'running_var')):
                np.testing.assert_allclose(x.numpy(), after[n].numpy(),
                                           atol=1e-6, err_msg=n)
    if not float32:
        return metrics, None, None
    assert set(got) == set(metrics)
    for k, v in got.items():
        x = metrics[k]
        lim = LOSS_RTOL * abs(x) + 1e-7
        if probe:
            lim = max(lim, abs(metrics32[k] - x))
        assert abs(v - x) <= lim, (k, v, x)
    fw = np.concatenate([jgrads[n].numpy().ravel() for n in grads])
    scale = float(np.linalg.norm(fw))
    gaps, zero, rounded = {}, {}, {}
    for n, g in grads.items():
        want = jgrads[n].numpy()
        if np.linalg.norm(want) <= ZERO_GRAD * scale:
            # a gradient that is 0 (a bias ahead of a train-mode BatchNorm,
            # which removes it): both sides' rounding only
            zero[n] = float(np.linalg.norm(g.numpy())) / scale
            continue
        if rounding and n.startswith(tuple(rounding)):
            rounded[n] = (rel(g.numpy(), want),
                          rel(grads32[n].numpy(), want))
            continue
        gaps[n] = rel(g.numpy(), want)
    dead = [n for n in zero if n.startswith(tuple(live))]
    assert not dead, dead
    bad = {n: v for n, v in gaps.items() if v > GRAD_REL_L2}
    bad.update({n: v for n, v in zero.items() if v > ZERO_GRAD})
    bad.update({n: v for n, v in rounded.items()
                if v[1] <= GRAD_REL_L2 or v[0] > v[1]})
    assert not bad, bad
    whole = rel(np.concatenate([g.numpy().ravel() for g in grads.values()]),
                fw)
    lim = GRAD_REL_L2_ALL
    if probe:
        worst32 = max(rel(grads32[n].numpy(), jgrads[n].numpy())
                      for n in gaps)
        lim = max(lim, rel(np.concatenate(
            [grads32[n].numpy().ravel() for n in grads]), fw))
    assert whole <= lim, (whole, lim)
    lr0 = liga_schedule(**LR)(0)
    clip = min(1.0, 35.0 / got['grad_norm'])
    clip_jax = min(1.0, 35.0 / metrics['grad_norm'])
    for n, v in port.state_dict().items():
        want = after[n].numpy()
        if n.endswith(('running_mean', 'running_var')):
            atol = STATS_ATOL
            if rounding and n.startswith(tuple(rounding)):
                err = np.abs(v.numpy() - want).max()
                rounded[n] = (err, np.abs(after32[n].numpy() - want).max())
                assert atol < rounded[n][1] and err <= rounded[n][1], \
                    (n, rounded[n])
                continue
        else:
            g = grads[n].numpy().astype(np.float64) * clip
            gw = jgrads[n].numpy().astype(np.float64) * clip_jax
            atol = lr0 * np.abs(g / (np.abs(g) + 1e-8) -
                                gw / (np.abs(gw) + 1e-8)) + PARAM_ATOL
        assert (np.abs(v.numpy() - want) <= atol).all(), n
    unused = [r for r in rounding if not any(n.startswith(r)
                                             for n in rounded)]
    assert not unused, unused
    if probe:
        print(f'JAX float32 step against the float64 step: worst parameter '
              f'{worst32:.3g}, whole vector {lim:.3g}', *(
                  ['(port, JAX float32) gaps of', rounded] if rounded
                  else []))
    return metrics, max(gaps.values()), whole


def jax_apply(jm, variables, args, train):
    """`jm.apply` jitted, numpy outputs and (train) the new batch_stats."""
    def f(v, *a):
        if train:
            return jm.apply(v, *a, train=True, mutable=['batch_stats'])
        return jm.apply(v, *a, train=False), {}
    out, upd = jax.jit(f)(variables, *jax.tree.map(jnp.asarray, list(args)))
    return jax.tree.map(np.asarray, out), jax.tree.map(np.asarray, upd)
