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
  `multi_transform` with `set_to_zero`); the reported `grad_norm` covers
  them too, as `optax.global_norm(grads)` does.

BatchNorm statistics update in the forward pass of a train-mode model
(`models/layers.py:BatchNorm`).
"""

import torch

from ..models.detectors.dfm import dfm_loss

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
    """One optimizer update of a DfM model: `__call__(img, meta, gt,
    generator)` -> metrics dict of scalar tensors (loss, each loss term,
    grad_norm), as JAX's `train_step`. The three phases are methods of
    their own (`forward`, `backward`, `update`) so that a caller can time
    them apart.

    Args:
        model: `DfM` (put in train mode here).
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

    def forward(self, img, meta, gt, generator=None, depth_pix_idx=None):
        """Train-mode forward and loss -> (total, dict of terms)."""
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        out = self.model(img, meta)
        anchors = self.model.anchors_per_class(out['cls_score'].shape[1:3],
                                               out['cls_score'].device)
        return dfm_loss(out, gt, self.model.cfg, anchors, generator,
                        depth_pix_idx)

    def backward(self, total):
        total.backward()

    def update(self):
        """Clip and apply the gradients -> the global gradient norm."""
        params = [p for p in self.model.parameters()]
        # a parameter the loss did not reach gets a zero gradient: optax
        # updates it all the same (its decay and moments), AdamW would skip
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
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
        return norm_all

    def __call__(self, img, meta, gt, generator=None, depth_pix_idx=None):
        total, losses = self.forward(img, meta, gt, generator, depth_pix_idx)
        self.backward(total)
        grad_norm = self.update()
        return dict(loss=total.detach(),
                    **{k: v.detach() for k, v in losses.items()},
                    grad_norm=grad_norm)
