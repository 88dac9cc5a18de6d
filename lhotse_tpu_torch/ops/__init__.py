"""PyTorch ops of the on-device augment→fbank path, and the CUDA fbank kernel."""
