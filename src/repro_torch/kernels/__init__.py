"""The kernels: the three server updates and flash attention, in CUDA C++
for Hopper (`csrc/`), their plain PyTorch versions (`ref`), the build
(`build`) and the dispatch (`ops`)."""
