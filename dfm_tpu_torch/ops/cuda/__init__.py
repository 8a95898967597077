"""Hand-written CUDA kernels of the port: build (`build.py`) and the
wrappers with their launch counts (`sampling.py` K1-K3, `conv_chain.py`
K4, K7a, K8a)."""
