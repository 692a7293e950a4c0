"""Bytes and float32 operations of one ``stdp_dense_update`` launch: the
kernel's contract is out of place, so every local weight is read and its
new value written (C N N each), beside the four (C, N) vectors it reads
(pre-traces of excitatory sources, their spikes, the spikes, the
post-traces); 7 operations a weight."""


def work(*, columns: int, n: int, tenants: int = 1) -> tuple:
    c = columns * tenants
    return 2 * c * n * n * 4 + 4 * c * n * 4, 7 * c * n * n
