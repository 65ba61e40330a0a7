"""The work a LightGCN step, eval and request need, counted from the
configuration's shapes (users n, items m, train pairs E, width d, layers
L, batch B) and not from any layout: the tiled layout's zero slots and
the ELL padding are not counted.

One layer of propagation is two products (items → users, users → items)
over the E pairs of the normalized adjacency: 2·2E·d operations; it
reads each pair's index and weight (8 B) in each product and the source
tables, and writes the destination tables. Backward is the same again.
The BPR loss gathers 3·B rows (and the backward writes them); Adam reads
p, m, v, g and writes p, m, v over (n + m)·d parameters.
"""

from __future__ import annotations

from benchmark.counts.peaks import least_s


def _shapes(cfg: dict):
    d, m = cfg["data"], cfg["model"]
    return d["n_users"], d["m_items"], d["n_train"], m["embedding_dim"], m["num_layers"]


def prop_work(cfg: dict, elem: int):
    """(flops, bytes) of one forward propagation."""
    n, m, E, d, L = _shapes(cfg)
    return L * 4.0 * E * d, L * (2 * 8.0 * E + 2 * elem * (n + m) * d)


def train_step_least(cfg: dict):
    """(seconds, bound) of one training step at the configured dtype."""
    n, m, E, d, L = _shapes(cfg)
    bf16 = cfg["model"].get("bf16_compute", False)
    elem = 2 if bf16 else 4
    B = cfg["train"]["batch_size"]
    f_prop, b_prop = prop_work(cfg, elem)
    params = (n + m) * d
    flops = 2 * f_prop + 3.0 * 2 * B * d * 2 + 12.0 * params
    nbytes = 2 * b_prop + 2 * 3.0 * B * d * 4 + 7.0 * 4 * params
    return least_s(flops, nbytes, "bfloat16" if bf16 else "float32")


def eval_least(cfg: dict, n_test_users: int, W: int, k: int):
    """(seconds, bound) of one full-catalog eval in fp32: one propagation,
    then every test user scored against every item (its user row, the item
    table and its bitset row read once, k ids and values written)."""
    n, m, E, d, L = _shapes(cfg)
    f_prop, b_prop = prop_work(cfg, 4)
    flops = f_prop + 2.0 * n_test_users * m * d
    nbytes = b_prop + 4.0 * (n_test_users * d + m * d + n_test_users * W) + 8.0 * n_test_users * k
    return least_s(flops, nbytes, "float32")
