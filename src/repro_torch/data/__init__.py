"""Data of the port: the synthetic MNIST stand-in and the synthetic
Markov-chain token data."""
from repro_torch.data.mnist import Dataset, make_synth_mnist
from repro_torch.data.tokens import TokenDataConfig, synthetic_token_batches
