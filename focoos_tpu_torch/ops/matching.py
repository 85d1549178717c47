"""Linear-sum assignment on the model's device by the auction algorithm.

Port of ``focoos_tpu/ops/matching.py:25-118`` (a Jacobi-style auction,
Bertsekas 1988, over dense [N, Q] bid tensors): the same cost normalisation,
first-argmax tie-breaking, relative ``eps``, ``max_iters`` bound and
``fill_unassigned`` safety net, so both packages assign alike. JAX solves the
batch as a ``vmap`` of a ``while_loop``, in which every problem stops updating
when its own condition fails; here all problems of a call (a training step
passes the 6 decoder layers + the encoder top-k × B images at once) advance in
one batched loop in which a finished problem's state is masked, and the host
asks whether any problem is still running only every ``CHECK_EVERY`` rounds:
each such check is a device→host sync.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30
CHECK_EVERY = 8  # rounds between two host checks for a running problem


def _fill_unassigned(assign: torch.Tensor, valid_rows: torch.Tensor, q: int) -> torch.Tensor:
    """Any valid row still unassigned (iteration cap) takes a free column:
    the k-th such row the k-th free column, in column order."""
    p, n = assign.shape
    cols = torch.arange(q, device=assign.device)
    taken = torch.zeros((p, q + 1), dtype=torch.bool, device=assign.device)
    taken.scatter_(1, torch.where(assign >= 0, assign, q), True)
    taken = taken[:, :q]
    need = (assign < 0) & valid_rows
    need_rank = need.long().cumsum(1) - 1
    free_cols = torch.argsort(torch.where(taken, q + cols, cols), dim=1)
    fill = torch.gather(free_cols, 1, need_rank.clamp(0, q - 1))
    return torch.where(need, fill, assign)


@torch.no_grad()
def batched_auction_assign(
    cost: torch.Tensor,  # [P, N, Q]: N rows (targets), Q >= N columns (queries)
    valid_rows: torch.Tensor,  # [P, N] bool; invalid rows are not assigned
    eps: float = 1e-2,
    max_iters: int = 500,
) -> torch.Tensor:
    """→ [P, N] int64, the column assigned to each row (undefined for invalid
    rows). ``eps`` is the bid increment relative to each problem's cost range."""
    p, n, q = cost.shape
    dev = cost.device
    cost = cost.float()
    finite = torch.where(valid_rows[..., None], cost, 0.0)
    lo = finite.amin(dim=(1, 2), keepdim=True)
    span = (finite.amax(dim=(1, 2), keepdim=True) - lo).clamp(min=1e-9)
    value = torch.where(valid_rows[..., None], -(cost - lo) / span, NEG_INF)

    prices = torch.zeros((p, q), device=dev)
    owner = torch.full((p, q), -1, dtype=torch.long, device=dev)
    assign = torch.full((p, n), -1, dtype=torch.long, device=dev)
    cols = torch.arange(q, device=dev)
    # a running problem takes every round, so the loop's bound is each
    # problem's max_iters; the rounds after a problem finished leave it as is
    rounds = 0
    while rounds < max_iters:
        unassigned = (assign < 0) & valid_rows
        running = unassigned.any(1)  # [P]
        if rounds % CHECK_EVERY == 0 and not bool(running.any()):
            break
        net = value - prices[:, None, :]  # [P, N, Q]
        best_j = net.argmax(-1)  # first argmax
        top1 = torch.gather(net, 2, best_j[..., None])[..., 0]
        second = torch.where(cols == best_j[..., None], NEG_INF, net).amax(-1)
        bid = torch.where(unassigned, torch.gather(prices, 1, best_j) + (top1 - second + eps), NEG_INF)

        # dense bid matrix: row i bids bid[i] on column best_j[i]
        bids = torch.full((p, n, q), NEG_INF, device=dev)
        bids.scatter_(2, best_j[..., None], bid[..., None])
        best_bid, winner = bids.max(1)  # [P, Q]; the first row on a tie
        has_bid = best_bid > NEG_INF / 2

        # previous owners of re-auctioned columns lose their assignment
        new_assign = torch.cat([assign, assign.new_full((p, 1), -1)], 1)
        new_assign.scatter_(1, torch.where(has_bid & (owner >= 0), owner, n), -1)
        # winners get their column (a row bids on one column, so wins at most one)
        win_col = assign.new_full((p, n + 1), -1)
        win_col.scatter_(1, torch.where(has_bid, winner, n), cols.expand(p, q))
        new_assign = torch.where(win_col[:, :n] >= 0, win_col[:, :n], new_assign[:, :n])

        run = running[:, None]
        assign = torch.where(run, new_assign, assign)
        owner = torch.where(run & has_bid, winner, owner)
        prices = torch.where(run & has_bid, best_bid, prices)
        rounds += 1
    batched_auction_assign.rounds = rounds
    return _fill_unassigned(assign, valid_rows, q)


batched_auction_assign.rounds = 0  # rounds the last call ran (a multiple of CHECK_EVERY, or max_iters)
