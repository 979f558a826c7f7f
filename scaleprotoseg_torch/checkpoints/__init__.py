"""Weight carry from the JAX package and the .pth/.ckpt.json format."""
