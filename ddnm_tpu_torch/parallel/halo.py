"""Halo rows of a 3x3 convolution over a map whose rows are split into
spatial shards (parallel/spatial.py).

A convolution's output rows of one shard read input rows of its
neighbours: a stride-1 3x3 convolution with padding 1 one row above and
one below; the ADM's stride-2 downsample with padding 1 one row above; the
DDPM's stride-2 downsample after its (0, 1, 0, 1) pad one row below. At
the image's top and bottom edges the halo rows are zeros, the
convolution's own zero padding; the columns keep theirs (padding (0, 1)).
With the halo in place, each shard's output rows are exactly those of the
unsharded convolution (for the stride-2 kinds when a shard's rows are
even).

Two parts, so that the arithmetic is testable without processes:
`exchange` is the collective (one all_gather of each shard's edge rows,
which every backend takes); `edge_rows`, `neighbour_rows` and `apply` are
what each shard sends, what it takes from the gathered rows, and the
concatenation. `pad` is the three together. Tensors are NCHW (the UNets'
layout, channels_last in memory), rows on axis 2.

The gradient (classifier guidance under spatial shards): where x requires
grad, `pad` runs as `HaloPad`, whose backward returns each halo row's
gradient to the shard that sent the row. A shard's gradient of its padded
map splits into its own rows' and its halo rows' (`halo_grads`); one
all_gather of every shard's halo-row gradients (counted under
"halo_grad"), and each shard adds the gradients of the rows it sent to
its edge rows (`add_sent_grads`): the shard above's gradient of its rows
below onto its first `below` rows, the shard below's gradient of its rows
above onto its last `above` rows. The zero rows at the image's edges were
sent by no one and take no gradient.
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["rows_needed", "edge_rows", "neighbour_rows", "apply", "exchange", "pad",
           "halo_grads", "add_sent_grads", "HaloPad"]

# (stride, padding) of a 3x3 convolution -> (rows above, rows below) it needs
_HALO = {(1, 1): (1, 1), (2, 1): (1, 0), (2, 0): (0, 1)}


def rows_needed(stride: int, padding: int) -> tuple[int, int]:
    """(rows above, rows below) that a shard of a 3x3 convolution with this
    stride and row padding reads from its neighbours; ValueError for
    another kind."""
    try:
        return _HALO[(int(stride), int(padding))]
    except KeyError:
        raise ValueError(f"no halo rule for a 3x3 convolution of stride {stride} and "
                         f"padding {padding}") from None


def edge_rows(x: torch.Tensor, above: int, below: int) -> torch.Tensor:
    """What a shard sends: its first `below` rows (its upper neighbour's
    rows below) and its last `above` rows (its lower neighbour's rows
    above), one contiguous (B, C, below + above, W) tensor."""
    h = x.shape[2]
    return torch.cat([x[:, :, :below], x[:, :, h - above:]], dim=2).contiguous()


def neighbour_rows(parts: Sequence[torch.Tensor], rank: int, above: int, below: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows above, rows below) of shard `rank` from every shard's
    `edge_rows` in rank order: the last `above` rows of the shard above and
    the first `below` rows of the shard below, zeros at the image's edges."""
    ref = parts[rank]
    b, c, _, w = ref.shape
    if rank > 0:
        up = parts[rank - 1][:, :, below:below + above]
    else:
        up = ref.new_zeros((b, c, above, w))
    if rank < len(parts) - 1:
        down = parts[rank + 1][:, :, :below]
    else:
        down = ref.new_zeros((b, c, below, w))
    return up, down


def apply(x: torch.Tensor, up: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    """x with its halo rows above and below, in x's memory format."""
    fmt = (torch.channels_last if x.is_contiguous(memory_format=torch.channels_last)
           and not x.is_contiguous() else torch.contiguous_format)
    out = torch.cat([up.to(x.dtype), x, down.to(x.dtype)], dim=2)
    return out.contiguous(memory_format=fmt)


def exchange(x: torch.Tensor, spatial, above: int, below: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows above, rows below) of this shard: one all_gather of every
    shard's edge rows over `spatial` (a SpatialGroup)."""
    parts = spatial.all_gather(edge_rows(x, above, below), "halo")
    return neighbour_rows(parts, spatial.rank, above, below)


def pad(x: torch.Tensor, spatial, above: int, below: int) -> torch.Tensor:
    """x with its neighbours' halo rows (zeros at the image's edges); with
    a gradient (`HaloPad`) where grad is on and x requires it."""
    if torch.is_grad_enabled() and x.requires_grad:
        return HaloPad.apply(x, spatial, above, below)
    return apply(x, *exchange(x, spatial, above, below))


def halo_grads(g: torch.Tensor, above: int, below: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(gradient of the shard's own rows, what it sends back) from the
    gradient `g` of its padded map (`apply`'s output): its rows, and its
    halo rows' gradients, those above then those below, as one contiguous
    (B, C, above + below, W) tensor."""
    h = g.shape[2] - above - below
    own = g[:, :, above:above + h]
    sent = torch.cat([g[:, :, :above], g[:, :, above + h:]], dim=2).contiguous()
    return own, sent


def add_sent_grads(own: torch.Tensor, parts, rank: int, above: int, below: int
                   ) -> torch.Tensor:
    """Shard `rank`'s gradient of its rows from its own rows' gradient and
    every shard's `halo_grads` in rank order: the shard above's gradient of
    its rows below (this shard's first `below` rows) and the shard below's
    of its rows above (this shard's last `above` rows) added, in that
    order."""
    dx = own.clone()
    h = dx.shape[2]
    if rank > 0 and below:
        dx[:, :, :below] += parts[rank - 1][:, :, above:above + below].to(dx.dtype)
    if rank < len(parts) - 1 and above:
        dx[:, :, h - above:] += parts[rank + 1][:, :, :above].to(dx.dtype)
    return dx


class HaloPad(torch.autograd.Function):
    """`pad` with the halo rows' gradient returned to their senders:
    apply(x, spatial, above, below) (module docstring)."""

    @staticmethod
    def forward(ctx, x, spatial, above, below):
        ctx.conf = (spatial, above, below)
        return apply(x, *exchange(x, spatial, above, below))

    @staticmethod
    def backward(ctx, g):
        spatial, above, below = ctx.conf
        own, sent = halo_grads(g, above, below)
        parts = spatial.all_gather(sent, "halo_grad")
        return add_sent_grads(own, parts, spatial.rank, above, below), None, None, None
