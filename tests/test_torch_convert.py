"""torch->flax conversion: numerical parity of converted layers."""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import torch

from dfm_tpu.utils.torch_convert import (convert_bn, convert_conv2d,
                                         convert_conv3d, convert_linear)

torch.set_num_threads(1)    # from import on; the workers share the cores


def test_conv2d_parity():
    tconv = torch.nn.Conv2d(4, 6, 3, padding=1, bias=True)
    x = np.random.RandomState(0).randn(1, 4, 8, 10).astype(np.float32)
    with torch.no_grad():
        ref = tconv(torch.from_numpy(x)).permute(0, 2, 3, 1).numpy()
    params = convert_conv2d(tconv.weight, tconv.bias)
    fconv = nn.Conv(6, (3, 3), padding=[(1, 1), (1, 1)])
    out = fconv.apply({'params': jax.tree.map(jnp.asarray, params)},
                      jnp.asarray(x.transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(np.asarray(out), ref, atol=1e-5)


def test_conv3d_parity():
    tconv = torch.nn.Conv3d(3, 5, 3, padding=1, bias=False)
    x = np.random.RandomState(1).randn(1, 3, 4, 6, 8).astype(np.float32)
    with torch.no_grad():
        ref = tconv(torch.from_numpy(x)).permute(0, 2, 3, 4, 1).numpy()
    params = convert_conv3d(tconv.weight)
    from dfm_tpu.models.layers import Conv3DSum
    m = Conv3DSum(5, (3, 3, 3), use_bias=False)
    out = m.apply({'params': jax.tree.map(jnp.asarray, params)},
                  jnp.asarray(x.transpose(0, 2, 3, 4, 1)))
    np.testing.assert_allclose(np.asarray(out)[0], ref[0], atol=1e-4)


def test_bn_parity_eval_mode():
    tbn = torch.nn.BatchNorm2d(4)
    tbn.running_mean.normal_()
    tbn.running_var.uniform_(0.5, 2.0)
    tbn.weight.data.normal_()
    tbn.bias.data.normal_()
    tbn.eval()
    x = np.random.RandomState(2).randn(2, 4, 5, 6).astype(np.float32)
    with torch.no_grad():
        ref = tbn(torch.from_numpy(x)).permute(0, 2, 3, 1).numpy()
    params, stats = convert_bn(tbn.weight, tbn.bias, tbn.running_mean,
                               tbn.running_var)
    fbn = nn.BatchNorm(use_running_average=True, epsilon=1e-5)
    out = fbn.apply({'params': jax.tree.map(jnp.asarray, params),
                     'batch_stats': jax.tree.map(jnp.asarray, stats)},
                    jnp.asarray(x.transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(np.asarray(out), ref, atol=1e-5)


def test_linear_parity():
    tl = torch.nn.Linear(7, 3)
    x = np.random.RandomState(3).randn(5, 7).astype(np.float32)
    with torch.no_grad():
        ref = tl(torch.from_numpy(x)).numpy()
    params = convert_linear(tl.weight, tl.bias)
    fl = nn.Dense(3)
    out = fl.apply({'params': jax.tree.map(jnp.asarray, params)},
                   jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(out), ref, atol=1e-5)


# compile-heavy: full tier only (pytest -m "not slow" skips)
import pytest  # noqa: E402
pytestmark = pytest.mark.slow
