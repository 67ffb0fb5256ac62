"""``verified_fail_share``: queries whose verified proof failed (the index's
``last_stats`` after each call) over the queries searched, in percent."""


def read(rec):
    if not rec.proof_queries:
        return None
    return 100.0 * rec.proof_failures / rec.proof_queries
