"""Faults planted in the port's timed path, each of which a cell's check
has to come out not correct on: a step that returns its state unchanged,
half of the batch left out (the mean taken over the rest), an answer
altered where it is produced. (Every cell runs on one chip: there is no
exchange between chips to leave out.) Each fault takes a ``setattr``
(``monkeypatch.setattr`` in a test, ``setattr`` in ``readings.py``) and
patches the port with it."""
import torch


def round_state_unchanged(set_attr):
    """The LM round hands back the global model it was given."""
    from repro_torch.launch import fl_round
    step = fl_round.fl_round_step

    def broken(clients, glob, *a, **k):
        _, div, labels = step(clients, glob, *a, **k)
        return {n: v.clone() for n, v in glob.items()}, div, labels
    set_attr(fl_round, "fl_round_step", broken)


def round_half_batch(set_attr):
    """The LM round's fold leaves out the first half of the clients and
    takes the mean over the rest."""
    from repro_torch.launch import fl_round
    weights = fl_round._round_weights

    def broken(div, labels, sizes, num_clusters):
        w = weights(div, labels, sizes, num_clusters).clone()
        w[: w.shape[0] // 2] = 0.0
        return w / torch.clamp(w.sum(), min=1e-9)
    set_attr(fl_round, "_round_weights", broken)


def round_divergence_altered(set_attr):
    """The last client's divergence one per cent high."""
    from repro_torch.launch import fl_round
    divergence = fl_round._divergence

    def broken(*a):
        d = divergence(*a).clone()
        d[-1] *= 1.01
        return d
    set_attr(fl_round, "_divergence", broken)


def fold_state_unchanged(set_attr):
    """The FedAvg fold hands back the global row it was given."""
    from repro_torch.strategies.aggregators import FedAvgAggregator
    set_attr(FedAvgAggregator, "aggregate_flat",
             lambda self, g, rows, w, opt=None: (g.clone(), opt))


def fold_half_batch(set_attr):
    """The FedAvg fold over the first half of the round's rows alone."""
    from repro_torch.kernels import ops
    from repro_torch.strategies.aggregators import FedAvgAggregator

    def broken(self, g, rows, w, opt=None):
        h = rows.shape[-2] // 2
        return ops.flat_aggregate(rows[..., :h, :].contiguous(),
                                  w[..., :h].contiguous()), opt
    set_attr(FedAvgAggregator, "aggregate_flat", broken)


def _sao_altered(set_attr, which: int):
    from repro_torch.strategies.allocators import SAOAllocator
    allocate = SAOAllocator.allocate_traced

    def broken(self, arr, B, mask):
        out = list(allocate(self, arr, B, mask))
        out[which] = out[which] * 1.01
        return tuple(out)
    set_attr(SAOAllocator, "allocate_traced", broken)


def latency_altered(set_attr):
    """SAO's reported round latency T one per cent high."""
    _sao_altered(set_attr, 0)


def energy_altered(set_attr):
    """SAO's reported round energy E one per cent high."""
    _sao_altered(set_attr, 1)


def selection_altered(set_attr):
    """Alg. 4 picks each cluster's second-largest divergence."""
    from repro_torch.strategies import traced
    top = traced._stable_top

    def broken(scores, k):
        vals, order = top(scores, k + 1)
        second = torch.where(torch.isfinite(vals[..., 1:]), order[..., 1:],
                             order[..., :k])
        return torch.gather(scores, -1, second), second
    set_attr(traced, "_stable_top", broken)


def labels_altered(set_attr):
    """K-means hands back the first client's label swapped with that of
    the first client of another cluster."""
    from repro_torch.core import engine
    fit = engine.kmeans_fit

    def broken(x, c, *a, **k):
        cent, labels, inertia = fit(x, c, *a, **k)
        other = int(torch.nonzero(labels != labels[0])[0])
        swapped = labels.clone()
        swapped[0], swapped[other] = labels[other], labels[0]
        return cent, swapped, inertia
    set_attr(engine, "kmeans_fit", broken)


def lane_misindexed(set_attr):
    """A cohort's lane 1 trains its clients from lane 0's global row: the
    view of lane 1 that the round's local SGD takes (``train_rows``) is
    lane 0's; the initial round, the fold and the selection read lane 1's
    own (one wrongly indexed lane)."""
    import sys
    from repro_torch.core import engine
    view = engine.lane_view

    def broken(tree, b):
        sgd = sys._getframe(1).f_code.co_name == "train_rows"
        return view(tree, 0 if sgd and b == 1 else b)
    set_attr(engine, "lane_view", broken)


FAULTS = {
    "fl_round": {"state unchanged": round_state_unchanged,
                 "half the batch": round_half_batch,
                 "an answer altered": round_divergence_altered},
    "fl_cohort": {"state unchanged": fold_state_unchanged,
                  "half the batch": fold_half_batch,
                  "an answer altered": latency_altered,
                  "energy altered": energy_altered,
                  "selection altered": selection_altered,
                  "labels altered": labels_altered,
                  "lane misindexed": lane_misindexed},
}
