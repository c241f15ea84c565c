"""Data of the port: the synthetic MNIST stand-in."""
from repro_torch.data.mnist import Dataset, make_synth_mnist
