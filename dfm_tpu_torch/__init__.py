"""dfm_tpu_torch: the DfM stack in PyTorch with hand-written CUDA kernels
for NVIDIA Hopper, beside the JAX package `dfm_tpu` (the reference it is
tested against). Entry points: `dfm_tpu_torch.apis`."""
