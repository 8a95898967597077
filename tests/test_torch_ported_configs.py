"""`tools.test --synthetic` of the port on its shipped non-mono configs, at
full size, float32 on the CPU.

One case a config: DfM-R34 KITTI, MultiViewDfM camsync and its 10-sweeps
form. Each decodes a synthetic batch through the config's own model at
the config's widths and must exit 0 with finite outputs. The mono configs'
cases stay beside their CLIs in `test_torch_kitti_mono.py`.
"""

import contextlib
import io
import os

import pytest
import torch

from dfm_tpu_torch.tools import test as test_cli

torch.set_num_threads(1)    # from import on; the workers share the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORTED_CONFIGS = ('dfm_r34_kitti_3class.py',
                  'multiview_dfm_r101_waymo_camsync.py',
                  'multiview_dfm_r101_waymo_camsync_10sweeps.py')


@pytest.mark.parametrize('config', PORTED_CONFIGS)
def test_tools_test_synthetic(config):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = test_cli.main([os.path.join(ROOT, 'configs', config),
                            '--device', 'cpu', '--dtype', 'float32',
                            '--synthetic'])
    text = buf.getvalue()
    assert rc == 0 and 'finite=True' in text, text
