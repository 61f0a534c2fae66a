"""Hand-written Hopper kernels (csrc/) beside their plain PyTorch versions;
``ops`` dispatches by the device of the inputs."""
