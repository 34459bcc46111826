"""Hand-written CUDA kernels for Hopper, their plain torch twins and the
wrappers that route a tensor to one or the other by its device."""
