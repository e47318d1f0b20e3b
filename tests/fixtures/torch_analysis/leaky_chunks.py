"""Seeded trace-check violation: a chunked loss whose loop LEAKS each
chunk's (chunk, M) kernel block into a list that is concatenated after the
loop — an (N, M) buffer, although the accumulation itself is chunked.
`assert_no_scaling(..., worse_than="N*M")` must flag exactly that
concatenation. The clean loss accumulates only; with its backward pass it
still saves every chunk's exp for autograd (O(N * M) in all) unless each
chunk is checkpointed, as `checkpointed_chunked_loss` does."""
import torch
import torch.utils.checkpoint

CHUNK = 256


def _block(xb, Z):
    return torch.exp(-((xb[:, None, :] - Z[None, :, :]) ** 2).sum(-1))


def leaky_chunked_loss(X, Z):
    acc = X.new_zeros(())
    blocks = []
    for i in range(0, X.shape[0], CHUNK):
        K = _block(X[i:i + CHUNK], Z)
        acc = acc + K.sum()
        blocks.append(K)  # the leak: every block outlives its chunk
    return acc + torch.cat(blocks).mean()


def clean_chunked_loss(X, Z):
    acc = X.new_zeros(())
    for i in range(0, X.shape[0], CHUNK):
        acc = acc + _block(X[i:i + CHUNK], Z).sum()
    return acc


def checkpointed_chunked_loss(X, Z):
    acc = X.new_zeros(())
    for i in range(0, X.shape[0], CHUNK):
        acc = acc + torch.utils.checkpoint.checkpoint(
            lambda xb, z: _block(xb, z).sum(), X[i:i + CHUNK], Z,
            use_reentrant=False)
    return acc
