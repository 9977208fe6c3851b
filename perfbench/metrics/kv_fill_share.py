"""Tokens the live rows hold at the window's close over the token slots
of the whole page pool (``pool_stats``: usable pages x page size), as a
share (%): how much of the pool that ``peak_mem_gib`` pays for the
traffic fills.  The engine maps a request's pages for its prompt and its
whole budget at admission, so mapped pages alone would hide the unfilled
budget."""


def read(ctx):
    pool = ctx.pool
    if not pool or not pool.get("n_pages"):
        return None
    return 100.0 * ctx.kv_tokens / (pool["n_pages"] * pool["page_size"])
