"""The paper's own problem sizes (Table 1) and the lineage connectivity
families as selectable configs (the port's copy of
``repro/configs/dpsnn.py``).

The 2015 scaling paper runs a short-range Gaussian lateral stencil; its
direct follow-ups (arXiv:1512.05264, arXiv:1803.08833) add an
exponential long-range decay. ``with_ranks`` scales a per-rank tile to
a rank count (the paper's weak-scaling protocol).
"""
import dataclasses

from repro_torch.configs.base import ConnectivityConfig, DPSNNConfig

GRID_24 = DPSNNConfig(name="dpsnn-24x24", grid_h=24, grid_w=24)
GRID_48 = DPSNNConfig(name="dpsnn-48x48", grid_h=48, grid_w=48)
GRID_96 = DPSNNConfig(name="dpsnn-96x96", grid_h=96, grid_w=96)

GRIDS = {"24x24": GRID_24, "48x48": GRID_48, "96x96": GRID_96}

#: The 2015 paper's stencil: Gaussian decay, 7x7 bound; the 1e-3 cutoff
#: leaves a realized (active-offset) radius of 2.
CONN_GAUSS = ConnectivityConfig()

#: Gaussian short-range + exponential long-range tail (arXiv:1512.05264).
CONN_GAUSS_EXP = ConnectivityConfig(
    lateral_profile="gauss_exp",
    amp_exp=0.03,
    lambda_steps=2.0,
    radius=6,
)

#: Pure exponential decay (arXiv:1803.08833), same tail parameters.
CONN_EXP = ConnectivityConfig(
    lateral_profile="exponential",
    amp_exp=0.03,
    lambda_steps=2.0,
    radius=6,
)

FAMILIES = {
    "gauss": CONN_GAUSS,
    "exp": CONN_EXP,
    "gauss_exp": CONN_GAUSS_EXP,
}


def with_family(cfg: DPSNNConfig, family: str) -> DPSNNConfig:
    """Rebind ``cfg`` to a named connectivity family (keeps everything
    else unchanged)."""
    conn = FAMILIES[family]
    return dataclasses.replace(cfg, name=f"{cfg.name}-{family}", conn=conn)


def with_ranks(cfg: DPSNNConfig, n_ranks: int) -> DPSNNConfig:
    """Weak-scaling config generator: treat ``cfg`` as the **per-rank
    tile** (its grid is one rank's share of columns) and scale the global
    grid to ``n_ranks`` processes on the closest-to-square process grid,
    so every rank owns ``cfg.n_columns`` columns at every ``n_ranks`` —
    the paper's Fig 3 protocol. ``with_ranks(RANK_TILE_PAPER, 1024)`` is
    the paper's largest run: 96x96 columns, ~11.4M neurons, ~20G
    equivalent synapses over 1024 software processes.
    """
    from repro_torch.core.partition import process_grid

    ry, rx = process_grid(n_ranks)
    return dataclasses.replace(
        cfg,
        name=f"{cfg.name}-r{n_ranks}",
        grid_h=cfg.grid_h * ry,
        grid_w=cfg.grid_w * rx,
    )


#: One rank's tile of the paper's largest configuration (Table 1/2
#: geometry): 3x3 columns of 1240 neurons per process.
RANK_TILE_PAPER = DPSNNConfig(name="dpsnn-rank-tile", grid_h=3, grid_w=3,
                              neurons_per_column=1240)


def reduced(grid_h=4, grid_w=4, neurons=64, **kw) -> DPSNNConfig:
    """Laptop-scale instance for tests/examples (same family, small)."""
    return DPSNNConfig(name=f"dpsnn-{grid_h}x{grid_w}-reduced",
                       grid_h=grid_h, grid_w=grid_w,
                       neurons_per_column=neurons, **kw)


def reduced_family(family: str, grid_h=4, grid_w=4, neurons=48, radius=2,
                   **kw) -> DPSNNConfig:
    """Laptop-scale instance of a connectivity family with a test-sized
    stencil bound (the family's decay profile, a smaller radius)."""
    conn = dataclasses.replace(FAMILIES[family], radius=radius)
    return DPSNNConfig(name=f"dpsnn-{grid_h}x{grid_w}-{family}",
                       grid_h=grid_h, grid_w=grid_w,
                       neurons_per_column=neurons, conn=conn, **kw)
