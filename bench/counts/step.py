"""The work a simulation step needs, whatever kernels do it: the least
bytes and operations that the model's definition asks of one loop step
of B tenants, from the configuration's shapes and the traced steps'
spikes. No intermediate array of an implementation is counted.

Bytes, each once:
* the synapses of the sources that spiked: a dense row of N local
  weights each, and K_tot remote synapses each (the mean out-degree of
  the ELL network, a weight and an index, 8 B), the weights shared by
  the tenants (static) or each tenant's own (STDP);
* each neuron's state read and written (v, c, refractory count: 24 B),
  its spike written (4 B), and under STDP its two traces read and
  written (16 B);
* under STDP: the weights the local rule changes, the rows and the
  columns of the neurons that spiked, read and written; every remote
  synapse (index read, weight read and written: 12 B), since the
  remote rule's depression term moves every synapse whose traces are
  not zero.

Operations: float32, a multiply-add (2) per synapse delivered, 14 per
neuron for the currents and LIF+SFA, 7 per weight the rules change;
int32, the Poisson drive's threefry draws, lam + 1 a neuron and step
(Knuth's loop), each ``ops_per_threefry``.
"""


def work(*, columns: int, n: int, k_total: int, tenants: int,
         spikes: float, stdp: bool, lam: float, ops_per_threefry: int
         ) -> tuple:
    """``(bytes, flops, int_ops)`` of one loop step; ``spikes``: the
    sources that spiked in the step's frame, summed over the tenants."""
    neurons = columns * n * tenants
    nbytes = spikes * (n * 4 + k_total * 8) + neurons * 28
    flops = 2 * spikes * (n + k_total) + 14 * neurons
    if stdp:
        nbytes += neurons * 16
        local = 2 * spikes * n          # rows and columns of who spiked
        nbytes += local * 8 + neurons * k_total * 12
        flops += 7 * (local + neurons * k_total)
    int_ops = neurons * (lam + 1.0) * ops_per_threefry
    return nbytes, flops, int_ops
