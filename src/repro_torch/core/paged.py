"""Paged KV-cache pool: block allocator, page tables, copy-on-write prefix
sharing (port of ``repro/core/paged.py``: ``NULL_PAGE`` (:77), the
allocator (:84-157), ``PagedData`` / ``init_paged`` (:164-227),
``gather_view`` / ``read_pages`` / ``pages_to_dense`` (:234-283),
``_tail_page`` / ``append_token`` / ``write_slab`` / ``write_chunk`` /
``append_chunk`` (:290-373), ``insert_row`` (:378-424),
``truncate_pages`` (:427-451), ``reset_rows`` (:454-464),
``int4_update_paged`` (:471-504), ``int4_prefill_chunk_paged``
(:507-540) and ``meta_nbytes`` (:547)).

K/V live in pools of ``(n_pages, H, page_size, c)`` blocks on the device;
row b maps its tokens ``[j*page_size, (j+1)*page_size)`` to physical
page ``page_table[b, j]``.  Page 0 (``NULL_PAGE``) is a pinned scratch
page: unmapped entries point at it and retired rows' masked writes land
there.  ``refcount[p]`` counts the table references to page p and free
pages are exactly ``refcount == 0``; ``pool_alloc`` hands out the lowest
free ids first (a stable sort of ``refcount != 0``), so its choices equal
the reference's exactly.

Where the port departs from the reference's layout:

  * The allocator is integer bookkeeping, so it lives on the host: the
    refcount vector is a CPU int32 tensor and the page table is kept
    twice, a CPU copy (``table_host``, what admission plans read) and the
    device copy the writes and kernel B2 index, uploaded only when the
    table changes (admission, retirement).  Nothing here reads the device
    back.
  * Lengths stay on the device, and the decode updates (``append_token``,
    ``int4_update_paged``) never read them on the host.  Every device
    buffer, the lengths and the page table included, keeps its address
    for the life of the state: a captured decode step replays them.
  * Device buffers are updated in place; the allocator functions return
    a fresh ``PagePool`` (a copy of a vector of ``n_pages`` ints).
  * ``insert_row`` writes only the freshly allocated pages; the reference
    also dumps the unwritten tiles into the scratch page, whose bytes are
    never meaningfully read.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import kvcache
from repro_torch.kernels.srft_quant.ops import quantize_rotated, rotate_quantize

__all__ = [
    "NULL_PAGE",
    "PagePool",
    "PagedData",
    "pool_init",
    "pool_n_free",
    "pool_used",
    "pool_alloc",
    "pool_incref",
    "pool_free",
    "init_paged",
    "gather_view",
    "read_pages",
    "pages_to_dense",
    "append_token",
    "write_slab",
    "write_chunk",
    "append_chunk",
    "insert_row",
    "truncate_pages",
    "reset_rows",
    "int4_update_paged",
    "int4_prefill_chunk_paged",
    "meta_nbytes",
]

NULL_PAGE = 0  # reserved scratch page: never allocated, never meaningfully read


def _host(x, dtype) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype, device="cpu")


# ---------------------------------------------------------------------------
# Block allocator (host)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PagePool:
    """Refcounting allocator over ``n_pages`` physical pages.  Page 0 is
    pinned at refcount 1 from init, so it is never allocated or freed."""

    refcount: torch.Tensor  # (n_pages,) int32, CPU


def pool_init(n_pages: int) -> PagePool:
    if n_pages < 2:
        raise ValueError(
            f"n_pages must be >= 2 (page 0 is the reserved null page), "
            f"got {n_pages}"
        )
    rc = torch.zeros((n_pages,), dtype=torch.int32)
    rc[NULL_PAGE] = 1
    return PagePool(rc)


def pool_n_free(pool: PagePool) -> int:
    return int((pool.refcount == 0).sum())


def pool_used(pool: PagePool) -> int:
    """Pages currently referenced, excluding the pinned null page."""
    return int((pool.refcount > 0).sum()) - 1


def pool_alloc(pool: PagePool, n: int, max_pages: int
               ) -> tuple[PagePool, torch.Tensor]:
    """Allocate ``n`` pages: ``(pool, pages)`` with ``pages`` of shape
    ``(max_pages,)`` -- the first ``n`` are fresh ids, lowest free first,
    the rest ``NULL_PAGE``.  Clamped to the free supply, so it never hands
    out a page in use."""
    rc = pool.refcount
    n_pages = rc.shape[0]
    order = torch.argsort((rc != 0).to(torch.int32), stable=True)
    i = torch.arange(max_pages)
    valid = (i < int(n)) & (i < pool_n_free(pool))
    pages = torch.where(valid, order[i.clamp(max=n_pages - 1)],
                        NULL_PAGE).to(torch.int32)
    refcount = rc.index_add(0, pages.long(), valid.to(torch.int32))
    return PagePool(refcount), pages


def pool_incref(pool: PagePool, pages) -> PagePool:
    """One more reference to every non-null page id in ``pages``."""
    pages = _host(pages, torch.int64).reshape(-1)
    return PagePool(pool.refcount.index_add(
        0, pages, (pages != NULL_PAGE).to(torch.int32)))


def pool_free(pool: PagePool, pages, valid=None) -> PagePool:
    """Drop one reference per (non-null, valid) page id, clamped at zero so
    a double free cannot take a live page negative."""
    pages = _host(pages, torch.int64).reshape(-1)
    mask = pages != NULL_PAGE
    if valid is not None:
        mask = mask & _host(valid, torch.bool).reshape(-1)
    dec = pool.refcount.index_add(0, pages, -mask.to(torch.int32))
    return PagePool(dec.clamp(min=0))


# ---------------------------------------------------------------------------
# Paged cache state
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PagedData:
    """Policy-agnostic paged state.  ``pools``: ``(n_pages, H, page_size,
    c_i)`` device tensors in the policy's leaf order (bf16: ``(k, v)``;
    int4: ``(k_packed, k_scales, v_packed, v_scales)``); ``residual``:
    per-row leaves that are not paged (the int4 fp32 window)."""

    pools: tuple
    residual: tuple
    page_table: torch.Tensor  # (B, max_pages) int32 on the pools' device
    table_host: torch.Tensor  # the same table on the CPU
    length: torch.Tensor  # (B,) int32 on the pools' device
    pool: PagePool

    @property
    def page_size(self) -> int:
        return self.pools[0].shape[-2]

    @property
    def n_pages(self) -> int:
        return self.pools[0].shape[0]

    @property
    def max_pages(self) -> int:
        return self.page_table.shape[-1]

    @property
    def s_max(self) -> int:
        return self.max_pages * self.page_size

    def upload_table(self) -> None:
        """Copy the host page table to the device (after it changed)."""
        self.page_table.copy_(self.table_host)


def init_paged(batch: int, s_max: int, *, page_size: int, n_pages: int,
               leaf_specs: tuple, residual_specs: tuple = (),
               device: "torch.device | str" = "cpu") -> PagedData:
    """Zeroed state: ``leaf_specs`` holds ``(H, c, dtype)`` per pooled
    leaf, ``residual_specs`` ``(H, W, d, dtype)`` per per-row leaf."""
    if page_size < 1:
        raise ValueError(f"page_size must be >= 1, got {page_size}")
    if s_max % page_size:
        raise ValueError(
            f"s_max={s_max} must be a multiple of page_size={page_size}"
        )
    max_pages = s_max // page_size
    table = torch.full((batch, max_pages), NULL_PAGE, dtype=torch.int32)
    return PagedData(
        pools=tuple(torch.zeros((n_pages, h, page_size, c), dtype=dt,
                                device=device)
                    for h, c, dt in leaf_specs),
        residual=tuple(torch.zeros((batch, h, w, d), dtype=dt, device=device)
                       for h, w, d, dt in residual_specs),
        page_table=table.to(device, copy=True),
        table_host=table,
        length=torch.zeros((batch,), dtype=torch.int32, device=device),
        pool=pool_init(n_pages),
    )


# ---------------------------------------------------------------------------
# Reads
# ---------------------------------------------------------------------------

def gather_view(pd: PagedData) -> tuple:
    """Dense per-row views ``(B, H, s_max, c_i)`` of every pool: equal to a
    dense slot cache's buffers at every valid position (positions past a
    row's length read whatever page the table maps, and every read masks
    them).  Kernel B2 never builds this view."""
    pt = pd.page_table.long()

    def g(leaf):
        t = leaf[pt]  # (B, MP, H, ps, c)
        B, MP, H, ps, c = t.shape
        return t.permute(0, 2, 1, 3, 4).reshape(B, H, MP * ps, c)

    return tuple(g(p) for p in pd.pools)


def read_pages(pd: PagedData, pages) -> tuple:
    """Dense ``(1, H, len(pages) * page_size, c_i)`` copies of the named
    pages, one per pool leaf: the donor-side read of token-level prefix
    reuse.  Null entries read the scratch page (garbage the caller
    overwrites).  A copy: it never aliases pool storage."""
    idx = torch.as_tensor(pages, dtype=torch.long).to(pd.pools[0].device)
    return tuple(pages_to_dense(p[idx]) for p in pd.pools)


def pages_to_dense(tiles: torch.Tensor) -> torch.Tensor:
    """``(NP, H, page_size, c)`` page tiles -> a dense batch-1
    ``(1, H, NP*page_size, c)`` leaf."""
    NP, H, ps, c = tiles.shape
    return tiles.permute(1, 0, 2, 3).reshape(1, H, NP * ps, c)


# ---------------------------------------------------------------------------
# Writes: tail page only
# ---------------------------------------------------------------------------

def _tail_page(pd: PagedData, pos: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(page ids (B,), in-page offsets (B,)) of per-row positions."""
    ps = pd.page_size
    j = (pos // ps).clamp(max=pd.max_pages - 1).long()
    page = pd.page_table.gather(1, j[:, None])[:, 0].long()
    return page, pos % ps


def append_token(pd: PagedData, vals: tuple,
                 active: "torch.Tensor | None" = None) -> PagedData:
    """Row b writes one token (``vals``: ``(B, H, 1, c_i)``) at position
    L_b of its tail page, in place.  Inactive rows write too -- past their
    unchanged length, or into the null page once retired -- and every
    read masks them."""
    page, off = _tail_page(pd, pd.length)
    for p, v in zip(pd.pools, vals):
        p[page, :, off.long(), :] = v[:, :, 0, :].to(p.dtype)
    pd.length.copy_(kvcache.advance(pd.length, active))
    return pd


def write_slab(pd: PagedData, slabs: tuple, starts: torch.Tensor,
               do: torch.Tensor) -> PagedData:
    """Row b writes a W-token slab (``(B, H, W, c_i)`` per leaf) at
    absolute position ``starts[b]`` where ``do[b]``, and writes back the
    bytes it gathered elsewhere (unchanged content, harmless even on a
    shared page).  ``page_size % W == 0`` and W-aligned starts keep a slab
    inside one page.  A row that does not flush may start mid-page: its
    offsets are clamped into the page (the reference's clamped gather), so
    it reads and writes back bytes of its own tail page only."""
    W = slabs[0].shape[2]
    page, off0 = _tail_page(pd, starts)
    off = (off0.long()[:, None] + torch.arange(W, device=off0.device)).clamp(
        max=pd.page_size - 1)
    pidx = page[:, None]
    for leaf, slab in zip(pd.pools, slabs):
        cur = leaf[pidx, :, off, :]  # (B, W, H, c)
        leaf[pidx, :, off, :] = torch.where(
            do[:, None, None, None], slab.transpose(1, 2).to(leaf.dtype), cur)
    return pd


def write_chunk(pd: PagedData, vals: tuple, starts: torch.Tensor
                ) -> PagedData:
    """Row b writes C tokens (``vals``: ``(B, H, C, c_i)`` per leaf) at
    absolute positions [starts_b, starts_b + C), in place; the span may
    cross pages, and each token finds its own page through the table (the
    routing of :func:`append_token`, widened to C).  The caller maps the
    pages first; unmapped entries route to the null page."""
    C, ps = vals[0].shape[2], pd.page_size
    pos = starts.long()[:, None] + torch.arange(C, device=starts.device)
    page = pd.page_table.gather(
        1, (pos // ps).clamp(max=pd.max_pages - 1)).long()
    off = pos % ps
    for p, v in zip(pd.pools, vals):
        p[page, :, off, :] = v.transpose(1, 2).to(p.dtype)
    return pd


def append_chunk(pd: PagedData, vals: tuple) -> PagedData:
    """Chunked prefill on a paged state: row b writes C tokens at [L_b,
    L_b + C) of its mapped pages and its length advances by C."""
    write_chunk(pd, vals, pd.length)
    pd.length.add_(vals[0].shape[2])
    return pd


# ---------------------------------------------------------------------------
# Admission / retirement
# ---------------------------------------------------------------------------

def insert_row(pd: PagedData, dense_leaves: tuple, residual_rows: tuple,
               row_length, slot: int, shared_pages, n_shared: int,
               n_new: int) -> PagedData:
    """Admit a prefilled dense batch-1 row (leaves ``(1, H, s_max, c_i)``)
    into ``slot``.  The first ``n_shared`` entries of ``shared_pages`` are
    copy-on-write prefix pages (refcounts bumped, bytes untouched);
    ``n_new`` fresh pages take the rest of the row's tiles.  The copy
    happens here, at fork time: the first unshared page is private, so
    decode writes never reach a shared page."""
    MP, ps = pd.max_pages, pd.page_size
    n_shared, n_new = int(n_shared), int(n_new)
    given = _host(shared_pages, torch.int32).reshape(-1)
    shared_pages = torch.full((MP,), NULL_PAGE, dtype=torch.int32)
    shared_pages[:given.shape[0]] = given
    pool, fresh = pool_alloc(pd.pool, n_new, MP)
    pool = pool_incref(pool, shared_pages)
    i = torch.arange(MP)
    row_pages = torch.where(i < n_shared, shared_pages,
                            fresh[(i - n_shared).clamp(0, MP - 1)])
    written = torch.arange(n_shared, n_shared + n_new)
    dev = pd.length.device
    tgt = row_pages[written].long().to(dev)
    src = written.to(dev)
    for leaf, dense in zip(pd.pools, dense_leaves):
        H, c = dense.shape[1], dense.shape[3]
        tiles = dense[0].reshape(H, MP, ps, c).transpose(0, 1)
        leaf[tgt] = tiles[src].to(leaf.dtype)
    for buf, r in zip(pd.residual, residual_rows):
        buf[slot] = r[0].to(buf.dtype)
    pd.table_host[slot] = row_pages
    pd.upload_table()
    pd.length[slot] = torch.as_tensor(row_length, device=dev).reshape(())
    pd.pool = pool
    return pd


def truncate_pages(pd: PagedData, new_lengths) -> PagedData:
    """Roll per-row lengths back to ``new_lengths`` (B,) and release the
    fully vacated tail pages: table entry j of row b survives iff j <
    ceil(L'_b / page_size); each released entry drops one reference (a
    COW sibling that still maps the page keeps it alive) and is nulled,
    and the table is uploaded.  Lengths only shrink.  The host-side
    structural API (ref ``paged.py:427``): the decode path never calls
    it, since a speculative rewind inside a pass is a length decrement
    and the slack pages are allocated at admission."""
    ps, MP = pd.page_size, pd.max_pages
    new = _host(new_lengths, torch.int64).reshape(-1)
    keep = -(-new // ps)
    drop = torch.arange(MP)[None, :] >= keep[:, None]
    pd.pool = pool_free(pd.pool, pd.table_host, drop)
    pd.table_host[drop] = NULL_PAGE
    pd.upload_table()
    pd.length.copy_(torch.minimum(
        pd.length, new.to(pd.length.device, pd.length.dtype)))
    return pd


def reset_rows(pd: PagedData, mask) -> PagedData:
    """Retire the masked rows: one reference dropped per mapped page
    (shared pages live on while other rows map them), table rows nulled,
    lengths zeroed.  Retired rows keep riding in the batch; their writes
    land in the null page."""
    mask = _host(mask, torch.bool).reshape(-1)
    valid = mask[:, None].expand(pd.table_host.shape)
    pd.pool = pool_free(pd.pool, pd.table_host, valid)
    pd.table_host[mask] = NULL_PAGE
    pd.upload_table()
    pd.length.masked_fill_(mask.to(pd.length.device), 0)
    return pd


# ---------------------------------------------------------------------------
# int4 paged decode update
# ---------------------------------------------------------------------------

def int4_update_paged(pd: PagedData, rot_k, rot_v, k: torch.Tensor,
                      v: torch.Tensor, active: "torch.Tensor | None" = None
                      ) -> PagedData:
    """Paged mirror of ``kvcache.decode_update_ragged``: the residual ring
    is per-row dense, and the W-token flush slab (kernel B3, no matrix)
    lands in the row's tail page through :func:`write_slab`.  Flush
    offsets are at or past the admission-time packed length, so they never
    touch a shared page."""
    k_res, v_res = pd.residual
    W = k_res.shape[-2]
    g = k_res.shape[-1] // pd.pools[1].shape[-1]
    L = pd.length
    idx = L % W
    kvcache.ring_write(k_res, rot_k.forward_at(k, kvcache.TOKEN), idx)
    kvcache.ring_write(v_res, rot_v.forward_at(v, kvcache.TOKEN), idx)
    kp, ks = quantize_rotated(k_res, group=g)
    vp, vs = quantize_rotated(v_res, group=g)
    write_slab(pd, (kp, ks, vp, vs), (L + 1 - W).clamp(min=0), idx == W - 1)
    L.copy_(kvcache.advance(L, active))
    return pd


def int4_prefill_chunk_paged(pd: PagedData, rot_k, rot_v, k: torch.Tensor,
                             v: torch.Tensor) -> PagedData:
    """Paged mirror of ``kvcache.prefill_chunk_ragged``: the chunk's
    W-aligned bulk (kernel B3) goes into the row's mapped pages through
    :func:`write_chunk` (``page_size % W == 0`` keeps every W-slab inside
    one page), and a final chunk's tail into the per-row residual ring at
    slots [0, C mod W).  The same alignment contract as the dense path."""
    k_res, v_res = pd.residual
    W = k_res.shape[-2]
    g = k_res.shape[-1] // pd.pools[1].shape[-1]
    C = k.shape[-2]
    packed_c = (C // W) * W
    if packed_c:
        kp, ks = rotate_quantize(k[..., :packed_c, :], rot_k, group=g)
        vp, vs = rotate_quantize(v[..., :packed_c, :], rot_v, group=g)
        write_chunk(pd, (kp, ks, vp, vs), pd.length)
    if C - packed_c:
        k_res[:, :, :C - packed_c] = rot_k.forward_at(
            k, kvcache.tail_from(packed_c))
        v_res[:, :, :C - packed_c] = rot_v.forward_at(
            v, kvcache.tail_from(packed_c))
    pd.length.add_(C)
    return pd


# ---------------------------------------------------------------------------
# Accounting
# ---------------------------------------------------------------------------

def meta_nbytes(pd: PagedData, *, per_shard: bool = False) -> int:
    """Bytes of paging metadata: page table + allocator refcounts (the
    device table; its host copy and the host refcounts are the same
    size).  Under a mesh every shard holds the same copy, so the
    ``per_shard`` figure (one shard's) equals the global one; the flag
    exists so that a per-device sum never books a "shard" of it."""
    return (pd.page_table.numel() * pd.page_table.element_size()
            + pd.pool.refcount.numel() * pd.pool.refcount.element_size())
