"""Work of one dense top-k call: Q queries of width d over N rows, k hits.

Operations 2 Q N d (every product once). Bytes: the corpus read once at 2
bytes an element (bf16, the least any exact route reads), the f32 queries
read once, and k (score, id) pairs of 4 + 4 bytes written a query.
"""


def count(shape: dict) -> tuple[float, float]:
    q, n, d, k = shape["queries"], shape["n"], shape["d"], shape["k"]
    return 2.0 * q * n * d, 2.0 * n * d + 4.0 * q * d + 8.0 * q * k
