"""The server-update kernels: CUDA C++ for Hopper (`csrc/`), their plain
PyTorch versions (`ref`), the build (`build`) and the dispatch (`ops`)."""
