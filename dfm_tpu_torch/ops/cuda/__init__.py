"""Hand-written CUDA kernels of the port: build (`build.py`) and the
wrappers with their launch counts (`sampling.py`)."""
