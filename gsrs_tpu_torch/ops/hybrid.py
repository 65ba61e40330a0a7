"""The dense-block memory guard of the hybrid and tiled layouts (port of
`gsrs_tpu.ops.hybrid`, lines 65-100: ``DENSE_HBM_BUDGET_GB`` and
`resolve_hybrid_cols`).

The tiled layout (`gsrs_tpu_torch.ops.tiled`) shares this guard. The
hybrid layout itself (`HybridGraph`, `hybrid_propagate_layer`) is not
ported yet: ROADMAP.md A3."""

from __future__ import annotations

import warnings

import torch

# Device-memory budget for the two dense hub blocks combined
# (user_from_item is (n_users, C), item_from_user is (m_items, C)): room
# is left for the embedding tables, the optimizer state, activations and
# the residual ELL. The blocks are O((n+m)·C), so at a 50M-user/10M-item
# shape they would need ~0.9 TB: `resolve_hybrid_cols` clamps C (down to
# 0 = plain ELL) with a warning instead of running out of memory.
DENSE_HBM_BUDGET_GB = 4.0


def resolve_hybrid_cols(
    n_users: int,
    m_items: int,
    cols: int,
    dtype: torch.dtype,
    hbm_budget_gb: float = DENSE_HBM_BUDGET_GB,
) -> int:
    """Clamp the hub-column count so the two dense blocks fit the budget.
    Returns ``cols`` unchanged when it fits; otherwise the largest
    128-multiple that does (possibly 0 — the dense blocks become empty
    and the layout degenerates to plain ELL), with a warning that names
    the estimate and the alternative."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    rows = n_users + m_items
    budget = int(hbm_budget_gb * 1024**3)
    need = rows * cols * itemsize
    if need <= budget:
        return cols
    fit = (budget // (rows * itemsize) // 128) * 128
    fit = int(max(fit, 0))
    warnings.warn(
        f"hybrid dense blocks at C={cols} would need "
        f"{need / 1024**3:.1f} GiB for {n_users}+{m_items} node rows "
        f"(budget {hbm_budget_gb:.1f} GiB); clamping to C={fit}"
        + (
            " — dense blocks disabled, effectively plain ELL. Use "
            "--spmm ell (and a sharded mesh) at this scale."
            if fit == 0
            else ". Raise hbm_budget_gb only if the chip has headroom."
        ),
        stacklevel=3,
    )
    return fit
