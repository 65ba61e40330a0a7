"""MovieLens → dataset directory converter (copy of
`gsrs_tpu.data.movielens`).

Any MovieLens ratings dump becomes a dataset directory with the artifacts
of the other converters (train.txt / test.txt / user_list.txt /
item_list.txt, ids densely remapped, each user's items in temporal order,
so the same directory feeds the sequential family), and train_times.txt,
each train item's rating time in seconds (the models with times, HSTU).

Input formats (auto-detected):
- ``u.data``        (ML-100K):  user<TAB>item<TAB>rating<TAB>timestamp
- ``ratings.dat``   (ML-1M/10M): user::item::rating::timestamp
- ``ratings.csv``   (ML-20M/25M): header + user,item,rating,timestamp

Implicit feedback: ratings >= ``min_rating`` are positives; users with
fewer than ``min_interactions`` positives are dropped. The split is
temporal per user: ``split="ratio"`` holds out the last ``test_frac`` of
each user's interactions, ``split="leave_last"`` exactly the last one.
pandas is imported only when a file is parsed.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _parse_ratings(path: str) -> np.ndarray:
    """Return an (N, 4) int64/float array [user, item, rating, ts]."""
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        first = f.readline()
    if "::" in first:
        sep, skip = "::", 0
    elif "\t" in first:
        sep, skip = "\t", 0
    else:
        sep = ","
        skip = 1 if any(c.isalpha() for c in first) else 0

    # vectorized parse: ML-25M is 25M rows — a per-line Python loop takes
    # minutes and GBs of list overhead; pandas reads it in seconds
    import pandas as pd

    kwargs = dict(
        sep=sep,
        skiprows=skip,
        header=None,
        engine="python" if sep == "::" else "c",
        on_bad_lines="skip",
    )
    try:  # every official ML format has 4 columns; tolerate 3 (no ts)
        df = pd.read_csv(
            path, usecols=[0, 1, 2, 3], names=["u", "i", "r", "t"], **kwargs
        )
    except ValueError:
        df = pd.read_csv(
            path, usecols=[0, 1, 2], names=["u", "i", "r"], **kwargs
        )
    df = df.dropna(subset=["u", "i", "r"])
    ts = df["t"].fillna(0).astype(np.float64) if "t" in df else 0
    return np.stack(
        [
            df["u"].astype(np.int64).to_numpy(),
            df["i"].astype(np.int64).to_numpy(),
            (df["r"].astype(np.float64) * 1000).astype(np.int64).to_numpy(),  # milli-stars
            np.asarray(ts, dtype=np.int64),
        ],
        axis=1,
    )


def prepare_movielens(
    ratings_path: str,
    out_dir: str,
    min_rating: float = 4.0,
    min_interactions: int = 5,
    split: str = "ratio",
    test_frac: float = 0.2,
) -> Tuple[int, int]:
    """Convert a MovieLens ratings file into a dataset directory.
    Returns (n_users, m_items) after dense remapping."""
    if split not in ("ratio", "leave_last"):
        raise ValueError(f"unknown split {split!r} (want 'ratio' or 'leave_last')")
    arr = _parse_ratings(ratings_path)
    arr = arr[arr[:, 2] >= int(min_rating * 1000)]
    if arr.size == 0:
        raise ValueError(f"no ratings >= {min_rating} in {ratings_path}")

    # temporal order per user (stable: ties keep file order)
    order = np.lexsort((arr[:, 3], arr[:, 0]))
    arr = arr[order]

    train_rows: List[Tuple[int, List[int]]] = []
    train_times: List[List[int]] = []
    test_rows: List[Tuple[int, List[int]]] = []
    boundaries = np.flatnonzero(np.diff(arr[:, 0])) + 1
    for grp in np.split(arr, boundaries):
        org_u = int(grp[0, 0])
        # dedupe items keeping first (earliest) occurrence
        _, first_idx = np.unique(grp[:, 1], return_index=True)
        its = grp[np.sort(first_idx), 1].tolist()
        ts = grp[np.sort(first_idx), 3].tolist()
        if len(its) < max(min_interactions, 2):
            continue
        n_test = 1 if split == "leave_last" else max(1, int(round(test_frac * len(its))))
        n_test = min(n_test, len(its) - 1)  # always keep >=1 train item
        train_rows.append((org_u, [int(i) for i in its[: len(its) - n_test]]))
        train_times.append([int(t) for t in ts[: len(its) - n_test]])
        test_rows.append((org_u, [int(i) for i in its[len(its) - n_test:]]))

    if not train_rows:
        raise ValueError("no users survive the min_interactions filter")

    from gsrs_tpu_torch.data.dataset import write_dataset_dir

    return write_dataset_dir(out_dir, train_rows, test_rows, train_times)


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(prog="gsrs_tpu_torch.data.movielens")
    ap.add_argument("--ratings", required=True, help="u.data / ratings.dat / ratings.csv")
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--min_rating", type=float, default=4.0)
    ap.add_argument("--min_interactions", type=int, default=5)
    ap.add_argument("--split", choices=["ratio", "leave_last"], default="ratio")
    ap.add_argument("--test_frac", type=float, default=0.2)
    args = ap.parse_args(argv)
    n, m = prepare_movielens(
        args.ratings,
        args.out_dir,
        min_rating=args.min_rating,
        min_interactions=args.min_interactions,
        split=args.split,
        test_frac=args.test_frac,
    )
    print(f"[movielens] wrote {args.out_dir}: {n} users, {m} items")


if __name__ == "__main__":
    main()
