"""The buffered-asynchronous engine — FL rounds as events, not barriers
(``repro.core.async_engine``).

Production FL has no round barrier: clients are dispatched, train at their
own pace, and the server folds updates as they land. A FedBuff tick
(Nguyen et al. 2022, ``fedbuff:M[:alpha]``) replaces the synchronous
round's barrier with a virtual-time loop:

* every dispatched client's finish time is priced by the paper's delay
  model — ``completion_times`` (eqs. 5+8) under the tick's allocation —
  and stamped as ``t_now + d`` into the stats table's ``t_done`` column;
* the buffer fires when the ``M`` earliest in-flight completions land,
  by completion RANK (a stable sort; the SAO allocator equalises its
  cohort's times, so a value cut would fire every tied client at once),
  folding them into the global row with staleness-discounted weights
  ``sizes · (1 + age)^(-alpha)`` through the same ``ops.flat_aggregate``
  row reduction, over the M gathered candidate rows only (O(M·P) a tick);
  stragglers stay in flight and age; an empty fire leaves the global row
  as it was;
* Bernoulli churn flips the stats table's availability mask at the start
  of each tick — a departure cancels the client's in-flight update — and
  selection never dispatches an unavailable or in-flight client.

One tick is one history row: ``RoundOutputs`` gains the participation,
staleness and active-fleet traces. The tick is built from the synchronous
round's closures (``engine.build_round_phases``) and runs as its round
body: on the card ``TracedProgram`` captures it once as a CUDA graph and
replays it once a tick, the churn uniforms graph inputs beside the fade
and the batch indices; every lane of a cohort goes through the same graph
(sorts, scatters and gathers along the last axis, lane by lane). With the
buffer at least the padded selection and no churn every dispatch fires
whole, so the tick takes a static branch that IS the synchronous round
body, and ``fedbuff:M:0`` is the synchronous run bit for bit.

Under a fault spec (``repro_torch.core.faults``) a tick takes its fault
draw at dispatch, as the reference's ``_async_fault_plan`` does: a lost or
corrupted upload is priced ``+inf`` (it never completes, never fires, is
never stored) and counted in the stats table's ``faults`` (a corrupted
one in ``strikes`` too), the byzantine clients' rows are transformed after
training, the fire's candidates pass the non-finite guard, and under
quarantine a client with ``quarantine_after`` strikes is never selected.

The paged store runs the same math as four pieces (``sched``, ``plan``,
``train``, ``fire``: :func:`build_paged_async`) over a carry that holds
the O(N) stats columns and the global row only, composed on the host
with the store's staging in between (``FLExperiment._run_async_paged``);
at ``div_refresh_every=1`` it is the dense tick bit for bit.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch

from repro_torch.core.engine import (EngineConfig, RoundOutputs,
                                     build_round_phases, lane_rows)
from repro_torch.core.faults import chan_outage_threshold
from repro_torch.core.wireless import completion_times, masked_max, masked_sum
from repro_torch.kernels import ops
from repro_torch.utils.spans import span

__all__ = ["build_async_phases", "build_paged_async", "parse_churn"]


def parse_churn(churn):
    """A churn spec as the ``(p_leave, p_join)`` float pair: ``None`` (no
    churn), one number or ``"0.3"`` (leave only), ``"p_leave:p_join"``, or
    a 2-sequence; each a per-tick Bernoulli probability in [0, 1]."""
    if churn is None:
        return (0.0, 0.0)
    if isinstance(churn, str):
        leave_s, _, join_s = churn.partition(":")
        parts = (leave_s, join_s or "0")
    elif isinstance(churn, (int, float)):
        parts = (churn, 0.0)
    else:
        parts = tuple(churn)
        if len(parts) != 2:
            raise ValueError(
                f"churn must be (p_leave, p_join); got {churn!r}")
    try:
        p = tuple(float(x) for x in parts)
    except (TypeError, ValueError):
        raise ValueError(
            f"churn must be numeric 'P_LEAVE[:P_JOIN]'; got {churn!r}"
        ) from None
    if not all(0.0 <= x <= 1.0 for x in p):
        raise ValueError(
            f"churn probabilities must lie in [0, 1]; got {p}")
    return p


def _last(x, idx):
    """``x[..., idx]`` along the last axis, lane by lane."""
    return torch.gather(x, -1, idx)


def _tick_math(ph, aggregator, churn):
    """The tick's pieces shared by the dense tick and the paged pieces, so
    the two compute the same bits: churn → select → in-flight filter
    (``schedule``), allocate → price → (faults) → stamp (``dispatch``),
    the fire plan (``fire_plan``), the non-finite guard on the candidates
    (``guard``), the guarded fold (``fold``) and the stats table after it
    (``settle``). Each returns new tensors and leaves the carry as it
    is."""
    N = ph.N
    M = int(aggregator.buffer_size)
    alpha = float(aggregator.staleness_alpha)
    p_leave, p_join = churn
    churn_on = p_leave > 0.0 or p_join > 0.0
    faults = ph.faults
    inf = float("inf")

    def churn_step(sched, u):
        """Flip the availability mask from the tick's uniforms ``u`` (``[...,
        2, N]``: leave, join); a departure cancels in-flight work."""
        leave = u[..., 0, :] < p_leave
        join = u[..., 1, :] < p_join
        avail = torch.where(sched.avail, ~leave, join)
        return sched._replace(
            avail=avail,
            t_done=torch.where(avail, sched.t_done,
                               torch.full_like(sched.t_done, inf)),
            age=torch.where(avail, sched.age, torch.zeros_like(sched.age)))

    def schedule(state, arr, draw, fade, churn_u):
        """Churn, then select on the faded fleet (availability exposed to
        the churn-aware policies as ``arr["avail"]``), then drop every lane
        whose client is unavailable or already in flight to the sentinel.
        Returns ``(state, faded arr, idx, mask)``, the state's ``sched``
        the churned table."""
        sched = state.sched
        if churn_on:
            sched = churn_step(sched, churn_u)
            state = state._replace(sched=sched)
            arr = dict(arr, avail=sched.avail.to(torch.float32))
        arr_f, idx, mask = ph.select_phase(state, arr, draw, fade)
        arr_f = dict(arr_f)
        arr_f.pop("avail", None)
        ok = sched.avail & ~torch.isfinite(sched.t_done)
        okpad = torch.cat([ok, torch.zeros_like(ok[..., :1])], dim=-1)
        mask = mask & _last(okpad, idx)
        idx = torch.where(mask, idx, torch.full_like(idx, N))
        return state, arr_f, idx, mask

    def fault_plan(state, sched, idx, mask, d, fault):
        """The dispatch-side faults (the reference's ``_async_fault_plan``,
        one function for the dense tick and the paged ``plan``): the drawn
        drops and corruptions, the channel-coupled and deadline drops. A
        failed upload is priced ``+inf`` — it never completes, never fires
        and is never stored — and counts in ``faults`` (a corrupt one, seen
        on receipt, in ``strikes`` too). Returns ``(sched, d, good)``,
        ``good`` the lanes whose rows may reach the store."""
        drop, corrupt = fault[0], fault[1]
        if faults.chan_outage > 0.0:
            gain = torch.sum(torch.square(state.channel), dim=-1)
            drop = drop | (_last(gain, ph.clamp(idx))
                           < chan_outage_threshold(faults.chan_outage))
        if faults.deadline > 0.0:
            drop = drop | (d > faults.deadline)
        bad = (drop | corrupt) & mask
        sched = sched._replace(
            faults=ph.add_counts(sched.faults, idx, mask, bad),
            strikes=ph.add_counts(sched.strikes, idx, mask, corrupt & mask))
        return (sched, torch.where(bad, torch.full_like(d, inf), d),
                mask & ~bad)

    def dispatch(state, sched, arr_f, idx, mask, fault=None):
        """Allocate over the dispatched lanes, price them, apply the
        dispatch's faults (an active fault spec) and stamp the completion
        times ``t_now + d`` into ``t_done`` (a padding lane's write goes to
        a column past N). Returns ``(T, E, band, t_done, sched, good)``:
        ``sched`` with the fault counts, ``good`` the lanes whose rows may
        be stored (``mask`` without faults)."""
        t = ph.clamp(idx)
        arr_sel = {k: lane_rows(v, t) for k, v in arr_f.items()}
        T, E, b, f = ph.allocator.allocate_traced(arr_sel, ph.B, mask)
        d = completion_times(arr_sel, b, f, mask)        # +inf on padding
        good = mask
        if ph.faults_on:
            sched, d, good = fault_plan(state, sched, idx, mask, d, fault)
        pads = torch.arange(idx.shape[-1], device=idx.device)
        store = torch.where(mask, idx, N + pads)
        ext = torch.cat([sched.t_done,
                         torch.full_like(d, inf)], dim=-1)
        ext = ext.scatter(-1, store, sched.t_now[..., None] + d)
        return T, E, masked_sum(b, mask), ext[..., :N], sched, good

    def fire_plan(sched, t_done, sizes):
        """The M earliest in-flight completions fire (fewer in flight: all
        of them); the candidates are ``order[:M]`` in client-index order,
        so the fold sums in the order a full-plane fold would. Returns the
        plan and the tick's traces (read at the pre-fold ages)."""
        inflight = torch.isfinite(t_done)
        order = torch.argsort(t_done, dim=-1, stable=True)
        rank = torch.zeros_like(order).scatter(
            -1, order, torch.arange(N, device=order.device).expand_as(order))
        fired = inflight & (rank < M)
        t_fire = torch.maximum(sched.t_now,
                               masked_max(t_done, fired, empty=sched.t_now))
        cand = torch.sort(order[..., :M], dim=-1).values
        fired_cand = torch.isfinite(_last(t_done, cand))
        w_cand = torch.where(fired_cand, _last(sizes, cand).to(torch.float32),
                             torch.zeros((), device=cand.device))
        if alpha != 0.0:
            w_cand = w_cand * aggregator.staleness_weights(
                _last(sched.age, cand))
        part = torch.sum(fired.to(torch.float32), dim=-1)
        stale = (torch.sum(torch.where(fired, sched.age,
                                       torch.zeros_like(sched.age)), dim=-1)
                 / torch.clamp(part, min=1.0))
        active = torch.sum(sched.avail.to(torch.float32), dim=-1)
        return SimpleNamespace(inflight=inflight, fired=fired, t_fire=t_fire,
                               cand=cand, fired_cand=fired_cand,
                               w_cand=w_cand, traces=(part, stale, active))

    def guard(sched, cand, cand_rows, w_cand, fired_cand):
        """The receive-side non-finite guard on the fire's candidates
        (under faults or quarantine): a fired NaN/Inf row is weighted out
        and strikes its sender. Returns ``(sched, w_cand, ok_cand,
        bad_cand)``, ``ok_cand`` the candidates whose rows were folded."""
        finite = torch.all(torch.isfinite(cand_rows), dim=-1)
        bad = fired_cand & ~finite
        sched = sched._replace(strikes=ph.add_counts(sched.strikes, cand,
                                                     None, bad))
        return (sched, torch.where(finite, w_cand, torch.zeros_like(w_cand)),
                fired_cand & finite, bad)

    def fold(state, cand_rows, w_cand, live):
        """The M candidate rows' fold; with no ``live`` candidate (an empty
        fire, or every fired row guarded out) the global row and the
        server state pass through. Returns ``(new row, new server state,
        ‖g_new − g_old‖)`` — a tensor ``where``, never a host branch."""
        agg, opt = aggregator.aggregate_flat(state.params, cand_rows, w_cand,
                                             state.opt_state)
        any_fired = torch.any(live, dim=-1, keepdim=True)
        new_gvec = torch.where(any_fired, agg, state.params)
        if opt is not None:
            opt = torch.where(any_fired, opt, state.opt_state)
        g_delta = torch.linalg.vector_norm(new_gvec - state.params, dim=-1)
        return new_gvec, opt, g_delta

    def settle(sched, t_done, plan):
        """Age the survivors, clear the fired, advance the clock."""
        fired = plan.fired
        return sched._replace(
            age=torch.where(plan.inflight & ~fired, sched.age + 1.0,
                            torch.zeros_like(sched.age)),
            t_done=torch.where(fired, torch.full_like(t_done, inf), t_done),
            t_now=plan.t_fire)

    return SimpleNamespace(M=M, churn_on=churn_on, schedule=schedule,
                           dispatch=dispatch, fire_plan=fire_plan,
                           guard=guard, fold=fold, settle=settle)


def _write_sched(dst, src) -> None:
    """Copy the columns of ``src`` that are new tensors into the carry's
    table ``dst`` in place (a captured tick's next replay reads them)."""
    for d, s in zip(dst, src):
        if s is not d:
            d.copy_(s)


def build_async_phases(cfg: EngineConfig, aggregator, selector, allocator,
                       tctx, feature_layer: str, base=None, *,
                       compressor=None, channel=None, churn=(0.0, 0.0),
                       faults=None, quarantine_after: int = 0,
                       byzantine=None):
    """The round closures of ``engine.build_round_phases`` with the
    buffered-asynchronous tick as ``round_body(state, arr, xgain, images,
    labels, sizes, batch_idx, test_images, test_labels, draw, fade,
    churn)`` over the dense plane: the carry's ``sched`` (a
    ``ClientStats`` with tensor columns) holds the scheduler's state, and
    ``churn`` is the tick's leave and join uniforms (``[2, N]``). A tick:

      1. churn flips ``sched.avail``; a departure cancels in-flight work;
      2. select on the faded fleet, then drop unavailable and in-flight
         clients' lanes to the sentinel N;
      3. dispatch: allocate, stamp ``t_now + d`` into ``t_done``, train
         the dispatched clients and write their rows into the plane;
      4. fire the M earliest in-flight completions: fold the candidate
         rows with ``sizes · (1 + age)^(-alpha)`` weights, advance the
         clock to the latest of them; an empty fire changes nothing;
      5. refresh the fired clients' divergence against the new row, grow
         everyone else's drift bound by ``‖g_new − g_old‖``, age the
         survivors, evaluate.

    Every tensor may carry a cohort's leading lane axis. With ``M >=
    S_pad`` and no churn the tick is the synchronous ``round_body``
    itself, the traces welded on (staleness 0, the whole fleet active).

    Under ``faults`` (and ``quarantine_after``, ``byzantine``: as for
    ``build_round_phases``) the tick takes its fault draw (``fault``,
    ``[2, S_pad]``) at dispatch: a lost or corrupted upload is priced
    ``+inf`` and never stored, the byzantine lanes' rows are transformed
    after training, the fire's candidates pass the non-finite guard, and
    a quarantined client is never selected; one run's carry only."""
    ph = build_round_phases(cfg, aggregator, selector, allocator, tctx,
                            feature_layer, base, compressor=compressor,
                            channel=channel, faults=faults,
                            quarantine_after=quarantine_after,
                            byzantine=byzantine)
    tm = _tick_math(ph, aggregator, churn)
    N = ph.N
    degenerate = tm.M >= selector.pad_size(tctx) and not tm.churn_on

    def tick(state, arr, xgain, images, labels, sizes, batch_idx,
             test_images, test_labels, draw=None, fade=None, churn=None,
             fault=None):
        sched0 = state.sched
        state, arr_f, idx, mask = tm.schedule(state, arr, draw, fade, churn)
        dev = state.params.device
        with span("fl.allocate", dev):
            T, E, band, t_done, sched, good = tm.dispatch(
                state, state.sched, arr_f, idx, mask, fault)
        with span("fl.train", dev):
            rows = ph.train_rows(state, idx, images, labels, batch_idx)
            if ph.byzantine:
                rows = ph.byz_transform(idx, state.params, rows)
        with span("fl.aggregate", dev):
            ph.store_rows(state, idx, mask, rows,
                          good if ph.faults_on else None)
            plan = tm.fire_plan(sched, t_done, sizes)
            cand_rows = lane_rows(state.client_params, plan.cand)
            w_cand, live, ok_cand = plan.w_cand, plan.fired_cand, None
            refreshed = plan.fired
            if ph.track_faults:
                sched, w_cand, ok_cand, bad = tm.guard(
                    sched, plan.cand, cand_rows, w_cand, plan.fired_cand)
                live = w_cand > 0.0
                # a guarded row refreshed nothing: its client leaves
                # flight but keeps accruing drift
                guarded = torch.zeros_like(plan.fired).scatter(-1, plan.cand,
                                                               bad)
                refreshed = plan.fired & ~guarded
            new_gvec, opt, g_delta = tm.fold(state, cand_rows, w_cand, live)
            div_cand = ops.client_divergence(cand_rows, new_gvec)
            sched = tm.settle(sched, t_done, plan)._replace(
                divergence=sched.divergence.scatter(
                    -1, plan.cand, torch.where(
                        plan.fired_cand if ok_cand is None else ok_cand,
                        div_cand, _last(sched.divergence, plan.cand))),
                drift=torch.where(refreshed,
                                  torch.zeros_like(sched.drift),
                                  sched.drift + g_delta[..., None]))
            _write_sched(sched0, sched)
            state.params.copy_(new_gvec)
            if opt is not None:
                state.opt_state.copy_(opt)
        with span("fl.evaluate", dev):
            acc, per_class = ph.evaluate_rows(state.params, test_images,
                                              test_labels, images)
        part, stale, active = plan.traces
        return state._replace(sched=sched0), RoundOutputs(
            accuracy=acc, T=T, E=E, selected=idx, mask=mask, band=band,
            per_class=per_class, participation=part, staleness=stale,
            active=active)

    def sync_tick(state, arr, xgain, images, labels, sizes, batch_idx,
                  test_images, test_labels, draw=None, fade=None,
                  fault=None):
        """The degenerate branch: the synchronous round body verbatim."""
        state, out = ph.round_body(state, arr, xgain, images, labels, sizes,
                                   batch_idx, test_images, test_labels,
                                   draw, fade, fault)
        lead = out.mask.shape[:-1]
        dev = out.mask.device
        return state, out._replace(
            participation=torch.sum(out.mask.to(torch.float32), dim=-1),
            staleness=torch.zeros(lead, device=dev),
            active=torch.full(lead, float(N), device=dev))

    out = SimpleNamespace(**vars(ph))
    out.round_body = sync_tick if degenerate else tick
    out.churn_on = tm.churn_on
    out.needs_sched = not degenerate or ph.track_faults
    out.degenerate = degenerate
    # the tick draws its faults at dispatch, before training's batch
    # indices; the synchronous branch after them, as the round does
    out.fault_first = not degenerate
    return out


def build_paged_async(cfg: EngineConfig, aggregator, selector, allocator,
                      tctx, feature_layer: str, base=None, *,
                      compressor=None, channel=None, churn=(0.0, 0.0),
                      faults=None, quarantine_after: int = 0,
                      byzantine=None):
    """One buffered-asynchronous tick over a paged store, as four eager
    pieces the host composes with store paging in between
    (``FLExperiment._run_async_paged``). The carry holds the global row,
    the server state and the stats table (``plane="stats"``: selection
    reads ``sched.divergence``, which the host refreshes), never an
    ``[N, P]`` plane; the same math and draw order as the dense tick
    (:func:`build_async_phases`, the degenerate branch aside):

    ``sched(state, arr, draw, churn)``
        churn → select → in-flight filter: ``(state, arr_f, idx, mask)``;
        every O(N) selection op.
    ``plan(state, arr_f, idx, mask, sizes, fault)``
        allocate → price → (faults) → stamp → fire plan; advances
        ``age``, ``t_done`` and ``t_now``: ``(state, T, E, band, cand,
        fired_cand, w_cand, good, (part, stale, active))``, ``good`` the
        dispatched lanes whose rows may be stored.
    ``train(state, images_sel, labels_sel, batch_idx, idx)``
        O(K·P) local SGD of the host-gathered cohort (the byzantine
        lanes' rows transformed): rows.
    ``fire(state, cand, cand_rows, w_cand, fired_cand, test_images,
    test_labels)``
        O(M·P) fold of the candidate rows staged back from the store (the
        non-finite guard first, under faults or quarantine), the
        empty-fire guard, evaluation: ``(state, accuracy, per_class,
        div_cand, g_delta, ok_cand)``, ``ok_cand`` the candidates whose
        rows were folded.
    """
    ph = build_round_phases(cfg, aggregator, selector, allocator, tctx,
                            feature_layer, base, compressor=compressor,
                            channel=channel, plane="stats", faults=faults,
                            quarantine_after=quarantine_after,
                            byzantine=byzantine)
    tm = _tick_math(ph, aggregator, churn)

    def sched(state, arr, draw=None, churn=None):
        with span("fl.select", state.params.device):
            return tm.schedule(state, arr, draw, None, churn)

    def plan(state, arr_f, idx, mask, sizes, fault=None):
        with span("fl.allocate", state.params.device):
            T, E, band, t_done, sched, good = tm.dispatch(
                state, state.sched, arr_f, idx, mask, fault)
            p = tm.fire_plan(sched, t_done, sizes)
            state = state._replace(sched=tm.settle(sched, t_done, p))
        return (state, T, E, band, p.cand, p.fired_cand, p.w_cand, good,
                p.traces)

    def train(state, images_sel, labels_sel, batch_idx, idx=None):
        with span("fl.train", state.params.device):
            rows = ph.train_gathered(state, images_sel, labels_sel,
                                     batch_idx)
            if ph.byzantine:
                rows = ph.byz_transform(idx, state.params, rows)
            return rows

    def fire(state, cand, cand_rows, w_cand, fired_cand, test_images,
             test_labels):
        with span("fl.aggregate", state.params.device):
            live = ok_cand = fired_cand
            if ph.track_faults:
                sched, w_cand, ok_cand, _ = tm.guard(
                    state.sched, cand, cand_rows, w_cand, fired_cand)
                state = state._replace(sched=sched)
                live = w_cand > 0.0
            new_gvec, opt, g_delta = tm.fold(state, cand_rows, w_cand, live)
            div_cand = ops.client_divergence(cand_rows, new_gvec)
            state = state._replace(params=new_gvec, opt_state=opt)
        with span("fl.evaluate", state.params.device):
            acc, per_class = ph.evaluate_row(new_gvec, test_images,
                                             test_labels)
        return state, acc, per_class, div_cand, g_delta, ok_cand

    return SimpleNamespace(churn_on=tm.churn_on, pad=selector.pad_size(tctx),
                           faults_on=ph.faults_on,
                           sched=sched, plan=plan, train=train, fire=fire)

