"""A simulation run in segments: the traffic of the ``segments`` mixes.

Set-up builds the network and state of ``--seed`` on the card
(``simulation.build``) and runs the mix's warm-up steps, past the onset
transient, through the entry the window uses. The window then calls
``simulation.run`` for ``segment_steps`` steps at a time (one simulated
second at dt = 1 ms), reads the population's spike count after each, as
a run that logs its rate does, and stops after the segment in which the
window's time ran out. A traced run profiles the window's second
segment.

What decides ``correct`` (:func:`judge`): the reference rebuilds the
network and state from the seed and runs the warm-up, to the bit against
the program's state after it (the start); then it runs the window's last
segment from the program's state at that segment's start, to the bit
against the program's state at its end. Under STDP the weights are state
too: the warm-up's are compared by digest, the last segment's element by
element, and the last segment starts from the program's weights.
"""
from __future__ import annotations

import time

import torch

from bench.harness import common
from bench.reference import dpsnn as ref

SMALL = ("v", "c", "refrac", "hist", "spike_count", "event_count", "x_pre",
         "x_post")


def leaves(state) -> dict:
    """The program's ``NetworkState`` as the reference's leaves."""
    out = dict(v=state.lif.v, c=state.lif.c, refrac=state.lif.refrac,
               hist=state.hist, spike_count=state.spike_count,
               event_count=state.event_count)
    if state.stdp is not None:
        out.update(x_pre=state.stdp.x_pre, x_post=state.stdp.x_post)
    return out


class Cell:
    def __init__(self, *, cfg: dict, mix: dict, seed: int, device,
                 tracer=None):
        from repro_torch.core import simulation
        self.sim = simulation
        self.cfg, self.mix, self.seed, self.dev = cfg, mix, seed, device
        self.stdp = bool(mix["stdp"])
        self.pcfg = common.program_config(cfg, seed, self.stdp)
        self.tracer = tracer
        self.trace = None
        self.outputs: dict = {}

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def setup(self) -> None:
        params, state = self.sim.build(self.pcfg, device=self.dev)
        res = self.sim.run(self.pcfg, params, state, self.mix["warmup_steps"],
                           impl=self.mix["impl"])
        self.params, self.state = res.params, res.state
        self._sync()
        warm = {k: v.cpu() for k, v in leaves(self.state).items()}
        warm["t"] = int(self.state.t)
        if self.stdp:
            warm["digests"] = {"w_local": common.digest(self.params.w_local),
                               "rem_w": common.digest(self.params.rem_w)}
        self.outputs["warm"] = warm
        if self.tracer is not None:          # the profiler's own start-up
            self.tracer.start()
            self.sim.run(self.pcfg, self.params, self.state, 2,
                         impl=self.mix["impl"])
            self.tracer.stop()

    def window(self, seconds: float) -> dict:
        seg = self.mix["segment_steps"]
        params, state = self.params, self.state
        segs = 0
        t0 = time.perf_counter()
        while True:
            start = (params, state)
            traced = self.tracer is not None and segs == 1
            if traced:
                self.tracer.start()
            res = self.sim.run(self.pcfg, params, state, seg,
                               impl=self.mix["impl"])
            float(res.spikes)               # the segment's rate, logged
            if traced:
                self.trace = self.tracer.stop(
                    steps=seg, spikes=float(res.spikes - state.spike_count),
                    tenants=1, stdp=self.stdp)
            params, state = res.params, res.state
            segs += 1
            done = time.perf_counter() - t0 >= seconds
            if done and (self.tracer is None or segs > 1):
                break
        self._sync()
        wall = time.perf_counter() - t0
        self.params, self.state = params, state
        self.outputs["last_start"] = start
        self.outputs["last_end"] = (params, state)
        self.outputs["segment_steps"] = seg
        return {"kind": "sim", "wall_s": wall, "sim_steps": segs * seg,
                "segments": segs, "dt_ms": self.cfg["neuron"]["dt_ms"]}

    def release(self) -> dict:
        """The outputs the check needs, with the program's network and
        state let go: small leaves on the host, and under STDP the weights
        at the last segment's start and end (the program's own state,
        which the reference starts from and is compared with)."""
        out = {"warm": self.outputs["warm"],
               "segment_steps": self.outputs["segment_steps"]}
        for tag in ("last_start", "last_end"):
            params, state = self.outputs[tag]
            d = {k: v.cpu() for k, v in leaves(state).items()}
            d["t"] = int(state.t)
            if self.stdp:
                d["w_local"], d["rem_w"] = params.w_local, params.rem_w
            out[tag] = d
        self.outputs = self.params = self.state = None
        return out


def _compare(got: dict, rs: ref.State, net: ref.Network | None) -> dict:
    """Mismatching elements, leaf by leaf, of the program's ``got``
    against the reference's state (and weights)."""
    out = {}
    want = rs.leaves()
    for k in SMALL:
        if k in got or k in want:
            if k not in got or k not in want:
                out[k] = 1
                continue
            out[k] = common.mismatches(got[k], want[k].to(got[k].device))
    out["t"] = int(got["t"] != rs.t)
    if net is not None:
        for k in ("w_local", "rem_w"):
            if k in got:
                out[k] = common.mismatches(got[k], getattr(net, k))
    return out


def judge(cfg: dict, mix: dict, seed: int, outputs: dict, device,
          order: str):
    """The checks of a run, ``({name: (value, limit)}, failed, detail)``,
    with the reference in ``order`` (``"kernel"`` on the card,
    ``"plain"`` on the CPU); ``failed`` counts the checked stretches (the
    warm-up, the last segment) that mismatch. Reads the program's outputs
    only to judge them."""
    stdp = bool(mix["stdp"])
    net = ref.build(cfg, seed, device)
    sim = ref.Sim(cfg, net, stdp=stdp, order=order, seed=seed)
    rs = ref.init_state(cfg, seed, device, stdp)
    sim.advance(rs, mix["warmup_steps"])
    warm = outputs["warm"]
    per = _compare(warm, rs, None)
    if stdp:
        for k in ("w_local", "rem_w"):
            per[k] = int(common.digest(getattr(net, k))
                         != warm["digests"][k]) * getattr(net, k).numel()
    start_bad = sum(per.values())
    # the last segment, from the program's state at its start
    st = outputs["last_start"]
    rs = ref.State(**{k: st[k].to(device).clone() if k in st else None
                      for k in ref.State.LEAVES}, t=st["t"])
    if stdp:
        net.w_local = st["w_local"].clone()
        net.rem_w = st["rem_w"].clone()
    outputs["last_start"] = None            # the program's weights go
    sim.advance(rs, outputs["segment_steps"])
    seg = _compare(outputs["last_end"], rs, net if stdp else None)
    checks = {"warmup_mismatches": (start_bad, 0),
              "last_segment_mismatches": (sum(seg.values()), 0)}
    failed = sum(v > lim for v, lim in checks.values())
    return checks, failed, {"warmup": per, "last_segment": seg}


def control_outputs(cfg: dict, mix: dict, seed: int, device, order: str,
                    weight_dtype=torch.bfloat16) -> dict:
    """The outputs of the control: the reference in the program's place,
    its weights held in ``weight_dtype`` (the precision below the
    configuration's float32), over the warm-up and one segment."""
    stdp = bool(mix["stdp"])
    net = ref.build(cfg, seed, device)
    net.w_local = net.w_local.to(weight_dtype).float()
    net.rem_w = net.rem_w.to(weight_dtype).float()
    sim = ref.Sim(cfg, net, stdp=stdp, order=order, seed=seed)
    rs = ref.init_state(cfg, seed, device, stdp)
    sim.advance(rs, mix["warmup_steps"])
    def host(state):
        return {k: v.detach().cpu().clone() for k, v in state.leaves().items()}

    warm = host(rs)
    warm["t"] = rs.t
    if stdp:
        warm["digests"] = {"w_local": common.digest(net.w_local),
                           "rem_w": common.digest(net.rem_w)}
    start = host(rs)
    start["t"] = rs.t
    if stdp:
        start["w_local"], start["rem_w"] = (net.w_local.clone(),
                                            net.rem_w.clone())
    sim.advance(rs, mix["segment_steps"])
    end = host(rs)
    end["t"] = rs.t
    if stdp:
        end["w_local"], end["rem_w"] = net.w_local, net.rem_w
    return {"warm": warm, "last_start": start, "last_end": end,
            "segment_steps": mix["segment_steps"]}
