"""A MoE run's routing, recorded on every rank of a serving mesh and
replayed on one device: the check that a mesh's MoE block computes one
device's block, up to rounding.

Under a mesh the sums come in another order, so the router inputs
differ from one device's in their last bits. Where two experts' router
scores nearly tie, that picks another expert; under "ep_a2a" a shard's
own capacity drops other assignments (``models.moe``). Either parts the
runs' tokens, and after that the tokens cannot tell a right mesh from a
wrong one. A replay takes the discrete choices out of the comparison:

- ``RouteRecord`` (its ``tap`` installed as ``moe.route_tap``) keeps
  every MoE call of an eager engine run by (step, row count T, layer):
  the rows a rank routed, their experts, keep mask and router
  log-probabilities, and which request and position each row holds.
- ``merge`` joins the ranks' records into whole calls (rows that two
  ranks both routed must agree).
- ``Replay.block`` stands in for ``moe.moe_block`` on one device
  (``replaying``). It routes each call itself and records that, then
  runs the mesh's experts for every row under the mesh mode's capacity
  rule ("ep_a2a": each S / tp slice with a capacity of its own).
- ``compare`` reads, over the rows whose context the two runs share,
  the largest gap between their router log-probabilities, each row
  whose mesh experts the replay's own router would not pick (with how
  far from a tie the replay's scores put them), and every call's
  assignments that the capacity rule keeps where the mesh dropped them,
  or back.

A mesh's expert set can differ from the replay's own top k only by a
tie within twice the row's log-probability gap (each score moved by at
most the gap), and a right mesh's gap is its rounding's. With the
routes the same, the two runs' logits differ only by rounding as well.
Eager runs only: every call reads the host.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.models import moe


def _logp(probs):
    return probs.float().clamp_min(1e-30).log()


class RouteRecord:
    """Every MoE call of one engine run on one rank (module docstring):
    ``calls[(step, T, layer)]`` = {"rows" (n,), "idx" (n, k), "keep"
    (n, k), "logp" (n, E)} on the host; ``names[(step, T)]`` = {row:
    (request, position)} of the named rows of that step's T-row calls
    (idle decode slots and chunk padding are unnamed)."""

    def __init__(self):
        self.calls, self.names = {}, {}
        self.step, self._layers = -1, {}

    def begin_step(self, names: dict) -> None:
        """Start a step whose T-row calls hold ``names[T]`` = {row:
        (request, position)}."""
        self.step += 1
        self._layers = {}
        for T, rows in names.items():
            self.names[(self.step, T)] = dict(rows)

    def key(self, T: int) -> tuple:
        """The next T-row call's key in this step (its layers in order)."""
        layer = self._layers.get(T, 0)
        self._layers[T] = layer + 1
        return self.step, T, layer

    def tap(self, idx, keep, rows, T, probs) -> None:
        """``moe.route_tap``."""
        self.put(self.key(T), rows, idx, keep, probs)

    def put(self, key, rows, idx, keep, probs) -> None:
        self.calls[key] = {"rows": rows.cpu(), "idx": idx.cpu(),
                           "keep": keep.cpu(), "logp": _logp(probs).cpu()}

    def rename(self, order: dict) -> None:
        """Name each request ``order[request]`` (its place in a list)."""
        self.names = {k: {row: (order[r], p) for row, (r, p) in m.items()}
                      for k, m in self.names.items()}

    def state(self) -> dict:
        return {"calls": self.calls, "names": self.names}


def merge(records: list) -> dict:
    """Ranks' ``RouteRecord.calls`` joined into whole calls: key ->
    {"idx" (T, k), "keep" (T, k), "logp" (T, E), "have" (T,)}. Raises
    ValueError where two ranks routed a row differently."""
    out = {}
    for calls in records:
        for key, c in calls.items():
            T = key[1]
            m = out.get(key)
            if m is None:
                m = out[key] = {
                    "idx": torch.zeros((T, c["idx"].shape[1]),
                                       dtype=c["idx"].dtype),
                    "keep": torch.zeros((T, c["idx"].shape[1]),
                                        dtype=torch.bool),
                    "logp": torch.zeros((T, c["logp"].shape[1])),
                    "have": torch.zeros(T, dtype=torch.bool)}
            rows = c["rows"]
            both = m["have"][rows]
            if both.any() and not (
                    torch.equal(m["idx"][rows][both], c["idx"][both])
                    and torch.equal(m["keep"][rows][both], c["keep"][both])):
                raise ValueError(f"MoE call {key}: two ranks routed the same "
                                 "rows differently")
            for name in ("idx", "keep", "logp"):
                m[name][rows] = c[name]
            m["have"][rows] = True
    return out


class Replay:
    """``block`` stands in for ``moe.moe_block`` on one device, replaying
    ``mesh`` (``merge``'s calls) of a mesh with "model" axis ``tp`` and
    no data split of the MoE rows (``f2d``: grok-1's layout). Its own
    routing goes into ``record`` (the caller names the steps' rows), with
    the keep mask of the mesh's experts under the mesh's capacity rule;
    ``missing`` counts the calls the mesh did not record whole (those run
    the replay's own experts)."""

    def __init__(self, mesh: dict, record: RouteRecord, tp: int,
                 f2d: bool = False):
        self.mesh, self.record, self.tp, self.f2d = mesh, record, tp, f2d
        self.missing = 0

    def block(self, params, x, cfg, with_aux: bool = False):
        if with_aux:
            raise ValueError("a route replay serves; it returns no aux")
        B, S, d = x.shape
        T, E = B * S, cfg.moe.num_experts
        key = self.record.key(T)
        xt = x.reshape(T, d)
        _, own, probs = moe._route(xt, params["router"].to(x.dtype),
                                   cfg.moe.experts_per_token)
        m = self.mesh.get(key)
        if m is None or not bool(m["have"].all()):
            self.missing += 1
            idx = own
        else:
            idx = m["idx"].to(x.device)
        w = probs.gather(1, idx)
        w = w / w.sum(dim=-1, keepdim=True).clamp(min=1e-9)
        # the mesh's sequence slices that route with a capacity of their own
        n = (self.tp if moe.block_mode(cfg, S, self.tp, self.f2d)
             == "ep_a2a" else 1)
        rows = torch.arange(T, device=x.device).view(B, S)
        wts = moe._weights(params, x.dtype, "ff", 0, 1, cfg)
        y = torch.empty_like(xt)
        keep = torch.empty_like(idx, dtype=torch.bool)
        Sl = S // n
        for s in range(n):
            sl = rows[:, s * Sl:(s + 1) * Sl].flatten()
            C = moe.capacity(cfg, B * Sl)
            pos = moe._positions_in_expert(idx[sl], E)
            kp = pos < C
            disp = moe._dispatch(xt[sl], idx[sl], pos, kp, E, C)
            comb = moe._expert_ffn(disp, *wts, moe._act(cfg))
            y[sl] = moe._combine(comb, idx[sl], pos, kp, w[sl], x.dtype)
            keep[sl] = kp
        self.record.put(key, torch.arange(T), own, keep, probs)
        return y.view(B, S, d)


def compare(mesh: dict, replay: dict, clean) -> dict:
    """The mesh's merged calls against a replay's ``RouteRecord.state()``
    of the same calls. Over the named rows for which ``clean(request,
    position)`` holds (a context both runs share): "rows", "logp_gap"
    (the largest |difference| of their router log-probabilities),
    "rerouted" (each row whose mesh experts are not the replay's own top
    k: request, position, layer, "tie" = the best expert the mesh left out
    less the worst it took, by the replay's scores, and "gap" = that
    row's largest log-probability difference). Over every row:
    "keep_diffs", the rows whose keep mask differs from the mesh's, and
    "calls" compared."""
    out = {"calls": 0, "rows": 0, "logp_gap": 0.0, "rerouted": [],
           "keep_diffs": 0}
    for key, r in replay["calls"].items():
        m = mesh.get(key)
        if m is None:
            continue
        out["calls"] += 1
        out["keep_diffs"] += int((m["keep"] != r["keep"]).any(-1).sum())
        names = replay["names"].get(key[:2], {})
        sel = sorted(row for row, (q, p) in names.items() if clean(q, p))
        if not sel:
            continue
        sel = torch.tensor(sel)
        out["rows"] += len(sel)
        gaps = (m["logp"][sel] - r["logp"][sel]).abs().amax(-1)
        out["logp_gap"] = max(out["logp_gap"], float(gaps.max()))
        differ = (r["idx"][sel].sort(-1).values
                  != m["idx"][sel].sort(-1).values).any(-1)
        for j in differ.nonzero().flatten().tolist():
            row = int(sel[j])
            lp = r["logp"][row]
            took = torch.zeros(lp.shape[0], dtype=torch.bool)
            took[m["idx"][row]] = True
            q, p = names[row]
            out["rerouted"].append({
                "request": q, "position": p, "layer": key[2],
                "tie": float(lp[~took].max() - lp[took].min()),
                "gap": float(gaps[j])})
    return out


@contextlib.contextmanager
def replaying(replay: Replay):
    """Make ``replay.block`` the MoE block for the block."""
    block = moe.moe_block
    moe.moe_block = replay.block
    try:
        yield replay
    finally:
        moe.moe_block = block
