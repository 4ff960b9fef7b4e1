"""The rule book of a sparse-conv neighbour map: what the kernels K5
(``csrc/subm_conv.cu``) and K6 (``csrc/subm_conv_dw.cu``) need to skip the
neighbours that do not exist.

A neighbour map is (Nq, K) int32: ``nbr[n, k]`` is the input row of query
row n's k-th kernel offset, or -1 where that neighbour is absent. Its rule
book holds

- ``masks``: (Nq,) int32, bit k set where ``nbr[n, k] >= 0``; a map of
  more than ``MAX_OFFSETS`` (31) offsets folds offset k onto bit k mod 31;
- ``order``: (Nq,) int64, the rows stably sorted by mask. K5 takes its
  output rows in this order, so the rows of one tile share their offsets
  and the tile skips every offset that none of its rows has (K5 finds a
  tile's offsets from the map itself, so the fold only groups rows);
- on first use by K6 (:meth:`RuleBook.pairs`), for every offset k the query
  rows that have it, compacted to the front of row k of a (K, Nq) table
  (rows Nq + 1 apart) in ascending order, with the counts on the device.

Masks and order come from :func:`subm_conv_rulebook`: on CUDA the
rule-book kernels of ``csrc/subm_conv.cu``, called once for all the maps
of a call (:func:`prepare_neighbor_maps`: a SECOND request's five); on the
CPU its plain version, torch ops and a stable sort a map. K6's lists are a
flat scan and a scatter. Nothing waits for the device (no ``nonzero``, no
boolean indexing, no ``.item()``). One rule book serves every launch on
its map: the forward and both backward kernels of every layer that shares
the map.

The build is the ``torch.library`` custom op
``d3d_tpu_torch::subm_conv_rulebook`` (CUDA: the kernels, counted; CPU:
the plain version; a fake implementation for tracing), so that
``torch.export`` keeps it as a node of a traced detector.
"""

import ctypes
from typing import List, Tuple

import torch

from ._build import load_library, stream_handle

__all__ = ["RuleBook", "prepare_neighbor_map", "prepare_neighbor_maps",
           "subm_conv_rulebook"]

# the presence mask is one int32 a row: 31 offsets a bit each, more folded
# (offset k onto bit k mod 31)
MAX_OFFSETS = 31
# the rule-book sort (csrc/subm_conv.cu): keys a block (kChunk), passes of
# 8 bits for 31 offsets (kMaxPasses) and digits a pass (kRadix)
_SORT_CHUNK = 2048
_SORT_MAX_PASSES = 4
_SORT_RADIX = 256

# made once per (K, device): two fewer launches a rule book, and no host
# copy of a constant (which would wait for the device)
_BITS = {}


def _offset_bits(k, device):
    """(k,) int32 ``1 << arange(k)`` on ``device``."""
    key = (k, device)
    if key not in _BITS:
        _BITS[key] = 1 << torch.arange(k, dtype=torch.int32, device=device)
    return _BITS[key]


def _check_map(nbr):
    if not isinstance(nbr, torch.Tensor) or nbr.ndim != 2 \
            or nbr.dtype != torch.int32:
        raise ValueError("a neighbour map is an (Nq, K) int32 tensor")


def _masks(nbr):
    """(Nq,) int32 presence masks of an (Nq, K) map; above 31 offsets,
    offset k sets bit k mod 31 (an OR of the folded columns)."""
    nq, k = nbr.shape
    present = nbr >= 0
    if k > MAX_OFFSETS:
        pad = -k % MAX_OFFSETS
        present = torch.nn.functional.pad(present, (0, pad)).view(
            nq, -1, MAX_OFFSETS).any(dim=1)
    return torch.where(present, _offset_bits(present.shape[1], nbr.device),
                       0).sum(dim=1, dtype=torch.int32)


def _sort_scratch_words(nqs):
    """The rule-book kernels' scratch in 64-bit words for maps of ``nqs``
    rows: two keys a row, a look-back slot per pass, chunk and digit (32
    bits each), a histogram per map, pass and digit (int32) and a ticket a
    pass (int32)."""
    chunks = sum(-(-nq // _SORT_CHUNK) for nq in nqs)
    slots = _SORT_MAX_PASSES * _SORT_RADIX
    return (2 * sum(nqs) + chunks * slots // 2 + len(nqs) * slots // 2
            + _SORT_MAX_PASSES // 2)


def _subm_conv_rulebook_plain(nbrs):
    """The plain version of :func:`subm_conv_rulebook`: each map's masks
    and their stable sort (torch ops)."""
    masks = [_masks(n) for n in nbrs]
    return masks, [torch.sort(m, stable=True).indices for m in masks]


def subm_conv_rulebook(nbrs):
    """K5's rule-book build: ``([masks], [order])``, one of each per map,
    of contiguous (Nq_i, K) int32 maps on one device with one K. On
    CUDA the rule-book kernels of ``csrc/subm_conv.cu`` (masks and digit
    counts, then a radix sort of 8-bit passes over every map's chunks of
    ``_SORT_CHUNK`` rows at once: one cooperative launch where the card
    holds every chunk's block, else a launch a phase; up to 16 maps a call;
    calls counted in ``subm_conv_rulebook.launches``), on the CPU its plain
    version: both give the masks and the stable sort of each map's rows by
    mask, bit for bit."""
    nqs = [n.shape[0] for n in nbrs]
    masks, order = torch.ops.d3d_tpu_torch.subm_conv_rulebook(list(nbrs))
    return list(masks.split(nqs)), list(order.split(nqs))


@torch.library.custom_op("d3d_tpu_torch::subm_conv_rulebook",
                         mutates_args=(), device_types="cpu")
def _rulebook_op(nbrs: List[torch.Tensor]) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """The rule-book build as an op: every map's masks, then every map's
    order, each laid end to end."""
    masks, order = _subm_conv_rulebook_plain(nbrs)
    return torch.cat(masks), torch.cat(order)


@_rulebook_op.register_fake
def _rulebook_fake(nbrs):
    rows = sum(n.shape[0] for n in nbrs)
    return (nbrs[0].new_empty(rows, dtype=torch.int32),
            nbrs[0].new_empty(rows, dtype=torch.int64))


@_rulebook_op.register_kernel("cuda")
def _rulebook_cuda(nbrs):
    nqs = [n.shape[0] for n in nbrs]
    dev = nbrs[0].device
    masks = torch.empty(sum(nqs), dtype=torch.int32, device=dev)
    order = torch.empty(sum(nqs), dtype=torch.int64, device=dev)
    if sum(nqs):
        words = _sort_scratch_words(nqs)
        scratch = torch.empty(words, dtype=torch.int64, device=dev)
        err = load_library("subm_conv").d3d_subm_conv_rulebook(
            (ctypes.c_void_p * len(nbrs))(*(n.data_ptr() for n in nbrs)),
            (ctypes.c_int * len(nbrs))(*nqs), len(nbrs), nbrs[0].shape[1],
            masks.data_ptr(), order.data_ptr(), scratch.data_ptr(), words,
            stream_handle(dev))
        if err:
            raise RuntimeError(f"rule-book kernel launch failed: CUDA error "
                               f"{err}")
        subm_conv_rulebook.launches += 1
        chunks = sum(-(-nq // _SORT_CHUNK) for nq in nqs)
        if dev.index not in _RESIDENT:
            _RESIDENT[dev.index] = load_library(
                "subm_conv").d3d_subm_conv_rulebook_resident()
        _ROUTES["one_launch" if chunks <= _RESIDENT[dev.index]
                else "per_phase"] += 1
    return masks, order


subm_conv_rulebook.launches = 0
# the chunks up to which a build is one cooperative launch, by device
_RESIDENT = {}
# builds by route (every call, checks included): one launch, or a launch a
# phase for inputs too large for the card to hold every chunk's block
_ROUTES = {"one_launch": 0, "per_phase": 0}


class RuleBook:
    """A neighbour map with its rule book (see the module docstring)."""

    __slots__ = ("nbr", "masks", "order", "_pairs")

    def __init__(self, nbr, _masks_order=None):
        _check_map(nbr)
        self.nbr = nbr.contiguous()
        self._pairs = None
        if _masks_order is not None:
            self.masks, self.order = _masks_order
        else:
            (self.masks,), (self.order,) = subm_conv_rulebook([self.nbr])

    @property
    def shape(self):
        return self.nbr.shape

    def pairs(self):
        """K6's lists, built on the first call: ``(out_rows, counts)``, a
        (K, Nq) int32 view of a (K, Nq + 1) table and (K,) int64 counts.
        Row k holds, in its first ``counts[k]`` entries, the query rows n
        (ascending) with ``nbr[n, k] >= 0``; the rest is -1 (the table's
        column 0, outside the view, takes the absent pairs' writes). K6
        reads each pair's input row from ``nbr`` itself."""
        if self._pairs is None:
            nq, k = self.nbr.shape
            dev = self.nbr.device
            # (K, Nq): one scan over all offsets' rows laid end to end, then
            # each offset's count before its row taken off (a cumsum along
            # either axis of a 2-D map runs as K or Nq short serial scans)
            present = (self.nbr >= 0).t().contiguous()
            pos = present.view(-1).cumsum(0).view(k, nq)       # int64
            pos = pos - pos[:, :1] + present[:, :1]
            rows = torch.arange(nq, dtype=torch.int32, device=dev)
            table = torch.full((k, nq + 1), -1, dtype=torch.int32,
                               device=dev)
            table.scatter_(1, torch.where(present, pos, 0),
                           rows.expand(k, nq))
            counts = (pos[:, -1].contiguous() if nq else
                      torch.zeros(k, dtype=torch.int64, device=dev))
            self._pairs = (table[:, 1:], counts)
        return self._pairs

    def k5_schedule(self, tile_rows):
        """(present pairs, pairs that K5's schedule multiplies) with tiles
        of ``tile_rows`` rows in rule-book order (the kernel's own:
        ``sparse_conv_cuda.k5_tile_rows``): a tile multiplies each of its
        rows at every offset that any of its rows has. A count on the host
        (it reads the device)."""
        nq, k = self.nbr.shape
        bit = self.nbr[self.order.long()] >= 0                 # (Nq, K)
        pad = -nq % tile_rows
        bit = torch.cat([bit, bit.new_zeros((pad, k))]).view(-1, tile_rows, k)
        real = (torch.arange(nq + pad, device=bit.device) < nq).view(
            -1, tile_rows).sum(dim=1)                         # rows a tile
        union = bit.any(dim=1).sum(dim=1)                     # per tile
        scheduled = int((union * real).sum())
        return int(bit.sum()), scheduled


def prepare_neighbor_map(nbr):
    """The :class:`RuleBook` of an (Nq, K) int32 neighbour map, built on its
    device (a RuleBook is returned as it is)."""
    return nbr if isinstance(nbr, RuleBook) else RuleBook(nbr)


def prepare_neighbor_maps(nbrs):
    """The :class:`RuleBook` of each of several (Nq_i, K) int32 neighbour
    maps on one device with one K, built together: on CUDA one call of the
    rule-book kernels for all of them (up to 16). The same rule books
    as :func:`prepare_neighbor_map` of each map."""
    for nbr in nbrs:
        _check_map(nbr)
    nbrs = [n.contiguous() for n in nbrs]
    if len({(n.shape[1], n.device) for n in nbrs}) > 1:
        raise ValueError("maps prepared together share K and a device: "
                         f"{[(tuple(n.shape), str(n.device)) for n in nbrs]}")
    if not nbrs:
        return []
    masks, orders = subm_conv_rulebook(nbrs)
    return [RuleBook(n, mo) for n, mo in zip(nbrs, zip(masks, orders))]
