"""One H3DNet training step against the JAX package, on the CPU (apart
from tests/test_torch_h3dnet.py so that each file stays within a minute
on one worker).

The shipped structure (the cues; two of the fixed SSG backbone towers,
16 proposals, 4 classes, 3 heading bins) on 2,500 points in a 2 m cube
with the height feature, gt boxes near the train-mode forward's initial
and refined proposals, against JAX's float64 `make_train_step` by
`torch_lidar_common.check_step` with `f64` and `probe`: the port's float64
step within 1e-6 of it (every loss term, every gradient, the BatchNorm
statistics), its float32 step's parameters within GRAD_REL_L2, its loss
terms and whole gradient vector within LOSS_RTOL / GRAD_REL_L2_ALL or as
far as JAX's own float32 step lies (measured: the port's worst parameter
5.3e-3, JAX's float32 step 1.28e-1 on it; whole vector 2.8e-3 against
JAX's 5.8e-2).
"""

import jax
import jax.numpy as jnp
import torch

import dfm_tpu.models.detectors.h3dnet as JH
from dfm_tpu_torch.models.detectors.h3dnet import H3DNet, H3DNetConfig
from dfm_tpu_torch.runtime.adapters import lidar_to_device
from dfm_tpu_torch.utils import weights as W

from test_torch_h3dnet import TINY, _targets
from test_torch_imvotenet import COMPILE, gt_near, scene
from test_torch_train_step import random_variables
from torch_lidar_common import check_step, t

torch.set_num_threads(1)    # from import on; the workers share the cores


def test_train_step_matches_jax():
    kw = dict(TINY, with_cues=True)
    jcfg, cfg = JH.H3DNetConfig(**kw), H3DNetConfig(**kw)
    jm = JH.H3DNet(cfg=jcfg)
    pts = scene(0)[:1]
    variables = random_variables(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), pts)), 1)
    key_map = W.h3dnet_key_map(cfg)
    sd = W.state_dict_from_jax(variables, key_map)
    probe = H3DNet(cfg)
    probe.load_state_dict(sd)
    with torch.no_grad():
        out = probe.train()(t(pts))
    gt = gt_near(_targets(jax.tree.map(lambda x: x.numpy(), {
        k: out[k] for k in ('initial', 'refined')})), 4)
    batch = dict(points=pts, **gt)
    port = H3DNet(cfg)
    port.load_state_dict(sd)

    def inputs64(model):
        p, mask, g = lidar_to_device(batch, 'cpu')
        return p.double(), mask, {k: v.double() if v.is_floating_point()
                                  else v for k, v in g.items()}

    metrics, worst, whole = check_step(
        jm, lambda o, bt: JH.h3dnet_loss(o, bt, jcfg), variables, key_map,
        port, jax.tree.map(jnp.asarray, batch), lambda bt: (bt['points'],),
        lidar_to_device(batch, 'cpu'),
        live=('ref_out.weight', 'rpn.vote0.weight', 'prim_line.vote.weight',
              'match_surf.weight', 'cue_obj.weight', 'fuse.weight',
              'backbone1.sa0.mlp0.weight'),
        f64=(JH.H3DNet(cfg=jcfg, dtype=jnp.float64), inputs64), probe=True,
        compiler_options=COMPILE)
    assert metrics['ref_loss_center'] > 0 and metrics['cues_semantic'] > 0
    print(f'port float32 step against JAX float64: worst parameter '
          f'{worst:.3g}, whole vector {whole:.3g}')
