"""Metric logging. Port of `dfm_tpu/runtime/logging.py` (`MetricsLogger`;
the reference's TextLoggerHook + TensorboardLoggerHook): scalars go to
`<work_dir>/metrics.jsonl`, one JSON object per logged step, and, when
asked for (`use_tensorboard`, off by default: importing
`torch.utils.tensorboard` may pull TensorFlow and its dependencies in),
to TensorBoard event files if `torch.utils.tensorboard` can be imported.
"""

import json
import os
import time

__all__ = ['MetricsLogger']


class MetricsLogger:
    """JSON lines + (optional) TensorBoard scalar logger."""

    def __init__(self, work_dir, use_tensorboard=False):
        os.makedirs(work_dir, exist_ok=True)
        self.jsonl_path = os.path.join(work_dir, 'metrics.jsonl')
        self._jsonl = open(self.jsonl_path, 'a')
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(
                    log_dir=os.path.join(work_dir, 'tf_logs'))

    def log(self, step, scalars, prefix='train'):
        rec = dict(step=int(step), time=time.time(),
                   **{f'{prefix}/{k}': float(v) for k, v in scalars.items()})
        self._jsonl.write(json.dumps(rec) + '\n')
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(f'{prefix}/{k}', float(v), int(step))

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
