"""Training engine: optimizer and train step.

Port of `dfm_tpu/runtime/train.py:41-113` (the reference's mmcv runner:
OptimizerHook grad clip 35, AdamW, LR hooks). The JAX package chains
`optax.clip_by_global_norm(35)` and `optax.adamw` under a schedule; here:

* the gradient norm is optax's global norm, sqrt(sum of g^2) over every
  gradient; the clip keeps g while norm < max_norm, else takes
  g / norm * max_norm (no + 1e-6, unlike
  `torch.nn.utils.clip_grad_norm_`), over the trained parameters;
* `torch.optim.AdamW` (b1 0.9, b2 0.999, eps 1e-8, decay decoupled and
  scaled by the learning rate) is optax's `adamw`, with the learning
  rate set from the schedule at each update (count 0 first);
* parameters under `frozen_prefixes` get no update and no decay (JAX's
  `make_optimizer(frozen_prefixes=...)`: `multi_transform` with
  `set_to_zero`; the LiDAR teacher of `DfMFull` and `DfMWithTeacher`
  under 'lidar_teacher'), and the clip's norm is over the trained ones,
  as optax clips within the 'train' partition; the reported
  `grad_norm` covers them too, as `optax.global_norm(grads)` does.

BatchNorm statistics update in the forward pass of a train-mode model
(`models/layers.py:BatchNorm`), the frozen LiDAR teacher's of a
`DfMFull` too (JAX's train step calls it with `train`).

In a process group (`parallel/dist.py`, torchrun) each rank runs the step
on its rows of the global batch; its loss is its share of the global
batch's loss (the normalisers are global counts), so the gradients are
summed over the group before the clip (one flat bucket), and the clip,
AdamW and the reported `grad_norm` and loss terms are the global batch's,
as JAX's step on the sharded batch gives them.
"""

import torch

from ..parallel import dist as D

__all__ = ['make_optimizer', 'global_norm', 'clip_by_global_norm',
           'TrainStep']


def make_optimizer(model, weight_decay=1e-4, frozen_prefixes=()):
    """AdamW over the parameters of `model` not under `frozen_prefixes`
    (module-name prefixes); the learning rate is set per update."""
    params = [p for n, p in model.named_parameters()
              if not n.startswith(tuple(frozen_prefixes))]
    return torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def global_norm(grads):
    """sqrt of the sum of squares of every tensor in `grads` (float32)."""
    return torch.sqrt(torch.stack([g.float().pow(2).sum()
                                   for g in grads]).sum())


def clip_by_global_norm(grads, max_norm, norm=None):
    """Scale `grads` in place to `max_norm` when their global norm (given,
    or computed here) is not below it (optax's rule); returns the norm.
    No host sync."""
    norm = global_norm(grads) if norm is None else norm
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


class TrainStep:
    """One optimizer update: `__call__(inputs, cond, gt, generator)` ->
    metrics dict of scalar tensors (loss, each loss term, grad_norm), as
    JAX's `train_step`. The phases are methods of their own (`forward`,
    `backward`, `reduce`, `update`) so that a caller can time them
    apart. The model's `forward_train(inputs, cond, gt, generator,
    depth_pix_idx)` gives the loss; the model-args function of its batch
    (`runtime/adapters.py:to_device` for DfM / DfMFull, `mv_to_device` for
    MultiViewDfM, as JAX's `model_args_fn`) gives the first three:
    (img, BatchMeta, gt) -> `dfm_loss`'s terms for a `DfM`; for a
    `DfMFull` `dfm_full_loss`'s, + loss_cls2d, loss_bbox2d,
    loss_centerness2d where gt has 2D targets, + loss_imitation where it
    has points; (imgs, lidar2img, gt) -> `mvdfm_loss`'s for a
    `MultiViewDfM`.

    Args:
        model: `DfM`, `DfMFull` or `MultiViewDfM` (put in train mode
            here).
        optimizer: from `make_optimizer`.
        schedule: count -> learning rate.
        step: the number of updates already taken (a resumed run's).
    """

    def __init__(self, model, optimizer, schedule, grad_clip_norm=35.0,
                 step=0):
        self.model = model
        self.optimizer = optimizer
        self.schedule = schedule
        self.grad_clip_norm = grad_clip_norm
        self.step = step
        self._trained = {id(p) for g in optimizer.param_groups
                         for p in g['params']}
        self._reduced = False
        self.reduce_bytes = 0

    def forward(self, img, meta, gt, generator=None, depth_pix_idx=None):
        """Train-mode forward and loss -> (total, dict of terms); in a
        process group, this rank's share of the global batch's."""
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        self._reduced = False
        return self.model.forward_train(img, meta, gt, generator,
                                        depth_pix_idx)

    def backward(self, total):
        total.backward()

    def reduce(self):
        """Give every parameter the loss did not reach a zero gradient
        (optax updates it all the same, its decay and moments; AdamW
        would skip it), then, in a process group, sum the gradients over
        the group (`dist.all_reduce_grads`; its bytes in
        `reduce_bytes`)."""
        params = list(self.model.parameters())
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.reduce_bytes = D.all_reduce_grads(params)
        self._reduced = True

    def update(self):
        """Clip and apply the (reduced) gradients -> the global gradient
        norm."""
        if not self._reduced:
            self.reduce()
        params = list(self.model.parameters())
        norm_all = global_norm([p.grad for p in params])
        trained = [p.grad for p in params if id(p) in self._trained]
        clip_by_global_norm(trained, self.grad_clip_norm,
                            norm_all if len(trained) == len(params)
                            else None)
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group['lr'] = lr
        self.optimizer.step()
        self.step += 1
        self._reduced = False
        return norm_all

    def __call__(self, img, meta, gt, generator=None, depth_pix_idx=None):
        total, losses = self.forward(img, meta, gt, generator, depth_pix_idx)
        self.backward(total)
        grad_norm = self.update()
        return dict(**D.sum_scalars(dict(
            loss=total.detach(),
            **{k: v.detach() for k, v in losses.items()})),
            grad_norm=grad_norm)
