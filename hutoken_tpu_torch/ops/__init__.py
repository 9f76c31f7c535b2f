"""PyTorch ops of the port: the merge fixed point and the fused kernel."""
