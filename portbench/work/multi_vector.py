"""Work of one MaxSim top-k call over valid tokens only.

Operations 2 d (sum of valid query tokens) (sum of valid page tokens): one
product of every query token with every page token of every page. Bytes: the
valid page tokens read once at 2 bytes an element, the f32 query tokens read
once, and k (score, id) pairs of 8 bytes written a query.
"""


def count(shape: dict) -> tuple[float, float]:
    d, tq, tp = shape["d"], shape["query_tokens"], shape["page_tokens"]
    return 2.0 * d * tq * tp, 2.0 * d * tp + 4.0 * d * tq + 8.0 * shape["queries"] * shape["k"]
