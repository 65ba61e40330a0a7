"""Instacart (Kaggle) → dataset directory converter (copy of
`gsrs_tpu.data.instacart`).

The reference's preprocessing: ``eval_set == 'prior'`` orders only; users
with fewer than ``min_orders`` prior orders dropped; an optional seeded
fractional user subsample; per user, the last prior order (by
order_number) is the test basket and the earlier orders train; dense id
remapping over users and the train ∪ test items; train.txt / test.txt and
the user_list.txt / item_list.txt mappings. Each user's train items are
written in temporal order (orders by order_number, items deduplicated
keeping the first occurrence), so the same directory feeds the
sequential family (`gsrs_tpu_torch.data.sequences`). pandas is imported
only when the converter runs.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def prepare_instacart(
    orders_csv: str,
    products_csv: str,
    out_dir: str,
    min_orders: int = 2,
    sample_frac: Optional[float] = None,
    seed: int = 2020,
) -> Tuple[int, int]:
    """Convert raw Instacart CSVs into a train.txt/test.txt dataset dir.
    Returns (n_users, m_items) after remapping."""
    import pandas as pd

    orders = pd.read_csv(orders_csv)
    orders = orders[orders["eval_set"] == "prior"]
    products = pd.read_csv(products_csv)

    merged = products.merge(
        orders[["order_id", "user_id", "order_number"]], on="order_id", how="inner"
    )
    # stable temporal order: user, then order_number, then CSV row order
    merged = merged.sort_values(
        ["user_id", "order_number"], kind="stable"
    ).reset_index(drop=True)

    # per-user prior-order counts → min_orders filter
    order_counts = orders.groupby("user_id")["order_id"].nunique()
    kept_users = order_counts[order_counts >= min_orders].index.to_numpy()
    if sample_frac is not None and sample_frac < 1.0:
        rng = np.random.default_rng(seed)
        n_keep = max(1, int(round(sample_frac * kept_users.size)))
        kept_users = np.sort(rng.choice(kept_users, size=n_keep, replace=False))
    merged = merged[merged["user_id"].isin(set(kept_users.tolist()))]

    train_rows: List[Tuple[int, List[int]]] = []  # (org_user, ordered items)
    test_rows: List[Tuple[int, List[int]]] = []
    for org_u, g in merged.groupby("user_id", sort=True):
        last_order = g["order_number"].max()
        is_test = g["order_number"].to_numpy() == last_order
        pids = g["product_id"].to_numpy()

        def _dedupe(vals: np.ndarray) -> List[int]:
            seen, out = set(), []
            for v in vals.tolist():
                if v not in seen:
                    seen.add(v)
                    out.append(int(v))
            return out

        train_items = _dedupe(pids[~is_test])
        test_items = _dedupe(pids[is_test])
        if not train_items or not test_items:
            continue
        train_rows.append((int(org_u), train_items))
        test_rows.append((int(org_u), test_items))

    from gsrs_tpu_torch.data.dataset import write_dataset_dir

    return write_dataset_dir(out_dir, train_rows, test_rows)


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(prog="gsrs_tpu_torch.data.instacart")
    ap.add_argument("--orders_csv", required=True)
    ap.add_argument("--products_csv", required=True)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--min_orders", type=int, default=2)
    ap.add_argument("--sample_frac", type=float, default=None)
    ap.add_argument("--seed", type=int, default=2020)
    args = ap.parse_args(argv)
    n, m = prepare_instacart(
        args.orders_csv,
        args.products_csv,
        args.out_dir,
        min_orders=args.min_orders,
        sample_frac=args.sample_frac,
        seed=args.seed,
    )
    print(f"[instacart] wrote {args.out_dir}: {n} users, {m} items")


if __name__ == "__main__":
    main()
