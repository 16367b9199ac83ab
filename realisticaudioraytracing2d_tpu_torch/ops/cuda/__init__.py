"""Hand-written CUDA kernels: build, bind and wrap."""
