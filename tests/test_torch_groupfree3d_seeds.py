"""Group-Free 3D's training step at other weights than
tests/test_torch_groupfree3d.py's, against the JAX package, on the CPU.

The step of `test_torch_groupfree3d.test_train_step_matches_jax` (its
small widths, points and gt boxes) with the weights of
`random_variables` seed 1: the port's float64 step within 1e-6 of JAX's
float64 `make_train_step` (every loss term, every gradient, the
BatchNorm statistics after it; `torch_lidar_common.check_step` with
`float32=False`). Its float32 steps are not judged here: at this seed
both packages' float32 gradients lie beyond check_step's rules from the
float64 step (worst parameter: the port's 5.6 %, JAX's own 6.2 %; whole
vector 2.28 % and 2.26 %).

`python tests/test_torch_groupfree3d_seeds.py SEED...` (from the repo's
root, with `PYTHONPATH=.`) prints, for each weight seed, each float32
step's gaps from JAX's float64 step and whether check_step's rules with
`probe` hold: the readings that ROADMAP.md §3 gives for seeds 1-8.
"""

import concurrent.futures
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

import dfm_tpu.models.detectors.groupfree3d as JG
from dfm_tpu_torch.models.detectors.groupfree3d import (GroupFree3DConfig,
                                                        GroupFree3DNet)
from dfm_tpu_torch.runtime.adapters import lidar_to_device
from dfm_tpu_torch.utils import weights as W

from test_torch_groupfree3d import TINY, gt_around, scene
from test_torch_train_step import (GRAD_REL_L2, GRAD_REL_L2_ALL, LOSS_RTOL,
                                   random_variables)
from torch_lidar_common import (_jax_step, _port_step, _to64, check_step,
                                jax_apply, rel)

torch.set_num_threads(1)    # from import on; the workers share the cores

COMPILE = {'xla_llvm_disable_expensive_passes': True}


def setup(seed):
    """The step's JAX module, float64 module, loss, variables (weights of
    `random_variables` seed `seed`), key map, port model and batch."""
    jcfg, cfg = JG.GroupFree3DConfig(**TINY), GroupFree3DConfig(**TINY)
    pts = scene(0)
    jm = JG.GroupFree3DNet(cfg=jcfg)
    variables = random_variables(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), pts)), seed)
    key_map = W.groupfree3d_key_map(cfg)
    out, _ = jax_apply(jm, variables, [pts], True)
    batch = dict(points=pts, **gt_around(out['query_points_xyz'], 4))
    port = GroupFree3DNet(cfg)
    port.load_state_dict(W.state_dict_from_jax(variables, key_map))
    return dict(jm=jm, jm64=JG.GroupFree3DNet(cfg=jcfg, dtype=jnp.float64),
                loss=lambda o, bt: JG.groupfree3d_loss(o, bt, jcfg),
                variables=variables, key_map=key_map, port=port,
                batch=batch)


def inputs64(batch):
    pts, mask, g = lidar_to_device(batch, 'cpu')
    return pts.double(), mask, {k: v.double() if v.is_floating_point()
                                else v for k, v in g.items()}


def test_train_step_float64_matches_jax_at_seed_1():
    s = setup(1)
    metrics, _, _ = check_step(
        s['jm'], s['loss'], s['variables'], s['key_map'], s['port'],
        jax.tree.map(jnp.asarray, s['batch']), lambda bt: (bt['points'],),
        lidar_to_device(s['batch'], 'cpu'),
        f64=(s['jm64'], lambda model: inputs64(s['batch'])), float32=False,
        compiler_options=COMPILE)
    assert metrics['loss_s1_center'] > 0 and metrics['loss_s1_size_res'] > 0


def step_readings(seed):
    """Each float32 step (the port's, JAX's) against JAX's float64 one
    at weight seed `seed` -> dict of the worst parameter's relative L2 and
    its name, the parameters beyond GRAD_REL_L2, the whole vector's gap,
    the grad_norm terms and whether check_step's rules with `probe` hold
    (the per-parameter, the whole-vector and the loss-term rule)."""
    s = setup(seed)
    jbatch = jax.tree.map(jnp.asarray, s['batch'])

    def model_args(bt):
        return (bt['points'],)

    def jax64():
        with jax.enable_x64():
            return _jax_step(
                s['jm64'], s['loss'], jax.tree.map(_to64, s['variables']),
                s['key_map'], jax.tree.map(
                    lambda x: jnp.asarray(_to64(np.asarray(x))), jbatch),
                model_args, COMPILE)

    with torch.backends.mkldnn.flags(enabled=False), \
            concurrent.futures.ThreadPoolExecutor(2) as pool:
        j32 = pool.submit(_jax_step, s['jm'], s['loss'], s['variables'],
                          s['key_map'], jbatch, model_args, COMPILE)
        j64 = pool.submit(jax64)
        got, grads = _port_step(s['port'], lidar_to_device(s['batch'],
                                                           'cpu'))
        (m32, g32, _), (m64, g64, _) = j32.result(), j64.result()
    scale = np.linalg.norm(np.concatenate([g64[n].numpy().ravel()
                                           for n in grads]))
    live = [n for n in grads if np.linalg.norm(g64[n].numpy()) >
            1e-5 * scale]
    readings = dict(seed=seed, grad_norm64=m64['grad_norm'])
    for who, gs, ms in (('port', grads, got), ('jax32', g32, m32)):
        gaps = {n: rel(gs[n].numpy(), g64[n].numpy()) for n in live}
        worst = max(gaps, key=gaps.get)
        readings[who] = dict(
            worst=(worst, gaps[worst]),
            beyond=sorted(n for n in gaps if gaps[n] > GRAD_REL_L2),
            whole=rel(np.concatenate([gs[n].numpy().ravel() for n in grads]),
                      np.concatenate([g64[n].numpy().ravel()
                                      for n in grads])),
            grad_norm=ms['grad_norm'])
    port_r, jax_r = readings['port'], readings['jax32']
    readings['rules'] = dict(
        per_parameter=not port_r['beyond'],
        whole=port_r['whole'] <= max(GRAD_REL_L2_ALL, jax_r['whole']),
        terms=all(abs(v - m64[k]) <= max(LOSS_RTOL * abs(m64[k]) + 1e-7,
                                         abs(m32[k] - m64[k]))
                  for k, v in got.items()))
    return readings


if __name__ == '__main__':
    for arg in sys.argv[1:]:
        print(json.dumps(step_readings(int(arg))), flush=True)
