"""Device ops of the PyTorch port: host grid math, the counter-hash RNG and the hand-written CUDA kernels."""
