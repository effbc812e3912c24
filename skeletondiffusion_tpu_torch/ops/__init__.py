"""Graph-NN building blocks (plain PyTorch) and the hand-written kernels
(``ops.kernels``)."""
