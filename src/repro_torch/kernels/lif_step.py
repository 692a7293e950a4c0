"""LIF+SFA neuron update on the card: ``csrc/lif_step.cu``.

Replaces ``repro/kernels/lif_step.py::lif_step``. Bound by bytes: 16
read and 16 written per neuron (22.9 MB per step on a 24x24 grid of
1240-neuron columns). Each thread updates four groups of four neurons
through 16-byte loads and stores, all its loads in flight before the
first use; any other n or alignment takes the same loop one neuron at a
time (the C entry chooses from the shapes and pointers). The constants
are computed once here, in float32, with the gain pre-folded
(``ref.lif_constants``).

On CPU tensors the wrapper returns the plain version, ``lif_step_ref``;
on CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import lif_constants, lif_step_ref


def lif_step(cfg, v, c, refrac, current):
    """Returns ``(v', c', refrac', spikes)``; ``cfg`` is a NeuronConfig."""
    consts = lif_constants(cfg, v.dtype)
    if v.device.type == "cpu":
        return lif_step_ref(v, c, refrac, current, **consts)
    shape = tuple(v.shape)
    f32 = torch.float32
    _build.check_args("lif_step", v.device, v=(v, f32, shape),
                      c=(c, f32, shape), refrac=(refrac, torch.int32, shape),
                      current=(current, f32, shape))
    v_out, c_out, s_out = (torch.empty_like(v) for _ in range(3))
    r_out = torch.empty_like(refrac)
    _build.launch("lif_step", "repro_lif_step", v.device,
                  v.data_ptr(), c.data_ptr(), refrac.data_ptr(),
                  current.data_ptr(), v_out.data_ptr(), c_out.data_ptr(),
                  r_out.data_ptr(), s_out.data_ptr(), v.numel(),
                  *_c_lif(consts))
    return v_out, c_out, r_out, s_out


def _c_lif(consts: dict) -> tuple:
    """The constants in the order of the C entry points' LIF arguments."""
    return (consts["decay_v"], consts["decay_c"], consts["gain"],
            consts["g_c"], consts["alpha_c"], consts["v_rest"],
            consts["v_reset"], consts["v_threshold"], consts["arp_steps"])
