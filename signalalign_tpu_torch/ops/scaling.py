"""Per-read signal normalization (assignments, weighted least squares,
method-of-moments, drift correction): the port's copy of
``signalalign_tpu.ops.scaling``.

reference: impl/nanopore.c:601-960 (nanopore_getOneDAssignmentsFromRead,
nanopore_compute_mean_scale_params, nanopore_compute_noise_scale_params,
drift adjustment) and impl/eventAligner.c:790-840 (MoM scaling). These
are tiny dense linear-algebra problems; they run vectorized in NumPy on
the host.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from signalalign_tpu_torch.models.pore_model import PoreModel, ScalingParams


def one_d_assignments(read: str, event_map: np.ndarray, events: np.ndarray,
                      model: PoreModel) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(event_mean, event_sd, delta_time, kmer_index) per first-mapped event.

    reference: nanopore_getOneDAssignmentsFromRead (nanopore.c:601-633):
    walk read positions; when the mapped event index advances, record the
    event paired with the k-mer at that position. K-mers containing
    characters outside the model alphabet are skipped (the reference would
    abort; reads with N bases are rare and the regression is robust to
    dropping them).
    """
    k = model.kmer_length
    rows = len(read) - (k - 1)
    digits = model.alphabet.seq_to_digits(read)
    ok = np.lib.stride_tricks.sliding_window_view(digits >= 0, k)[:rows].all(axis=1)
    windows = np.lib.stride_tricks.sliding_window_view(
        np.where(digits < 0, 0, digits), k)[:rows]
    kmer_ids = windows @ model.alphabet._powers

    ev_idx = event_map[:rows]
    first = np.zeros(rows, dtype=bool)
    prev = -1
    for i in range(rows):
        if ev_idx[i] > prev:
            first[i] = True
            prev = ev_idx[i]
    sel = first & ok
    e = ev_idx[sel]
    return (events[e, 0].copy(), events[e, 1].copy(), events[e, 3].copy(),
            kmer_ids[sel].astype(np.int64))


def compute_mean_scale_params(level_mean: np.ndarray, level_sd: np.ndarray,
                              means: np.ndarray, times: np.ndarray,
                              kmer_ids: np.ndarray,
                              with_drift: bool = True,
                              with_var: bool = True) -> Tuple[float, float, float, float]:
    """Weighted LS fit of event_mean ~ shift + scale*mu [+ drift*t].

    Returns (shift, scale, drift, var).
    reference: nanopore_compute_mean_scale_params (nanopore.c:756-888).
    """
    if len(means) == 0:
        raise ValueError("cannot estimate scale params with no assignments")
    mu = level_mean[kmer_ids]
    sd = level_sd[kmer_ids]
    w = 1.0 / (sd * sd)
    if with_drift:
        X = np.stack([np.ones_like(mu), mu, times], axis=1)
    else:
        X = np.stack([np.ones_like(mu), mu], axis=1)
    XtW = X.T * w
    beta = np.linalg.solve(XtW @ X, XtW @ means)
    shift, scale = float(beta[0]), float(beta[1])
    drift = float(beta[2]) if with_drift else 0.0
    var = 1.0
    if with_var:
        pred = X @ beta
        disp = np.sum((means - pred) ** 2 * w)
        var = float(np.sqrt(disp / len(means)))
    return shift, scale, drift, var


def compute_noise_scale_params(noise_mean: np.ndarray, noise_sd: np.ndarray,
                               event_noise: np.ndarray,
                               kmer_ids: np.ndarray) -> Tuple[float, float, float]:
    """Weighted LS fit of event_noise ~ shift_sd + scale_sd*noise_mean.

    Returns (shift_sd, scale_sd, var_sd).
    reference: nanopore_compute_noise_scale_params (nanopore.c:889-960).
    """
    nm = noise_mean[kmer_ids]
    nsd = noise_sd[kmer_ids]
    w = 1.0 / (nsd * nsd)
    X = np.stack([np.ones_like(nm), nm], axis=1)
    XtW = X.T * w
    beta = np.linalg.solve(XtW @ X, XtW @ event_noise)
    pred = X @ beta
    disp = np.sum((event_noise - pred) ** 2 * w)
    var_sd = float(np.sqrt(disp / len(event_noise)))
    return float(beta[0]), float(beta[1]), var_sd


def estimate_nanopore_params(read: str, event_map: np.ndarray,
                             events: np.ndarray, model: PoreModel,
                             params: Optional[ScalingParams] = None) -> ScalingParams:
    """Full re-estimation as done per read by signalMachine.

    reference: signalUtils_estimateNanoporeParams
    (signalMachineUtils.c:186-228): 1D assignments -> WLS shift/scale/drift/
    var -> noise WLS -> caller applies drift adjustment + noise rescale.
    """
    out = ScalingParams() if params is None else params
    means, sds, times, ids = one_d_assignments(read, event_map, events, model)
    shift, scale, drift, var = compute_mean_scale_params(
        model.level_mean, model.level_sd, means, times, ids)
    shift_sd, scale_sd, var_sd = compute_noise_scale_params(
        model.noise_mean, model.noise_sd, sds, ids)
    out.shift, out.scale, out.drift, out.var = shift, scale, drift, var
    out.shift_sd, out.scale_sd, out.var_sd = shift_sd, scale_sd, var_sd
    return out


def adjust_events_for_drift(events: np.ndarray, drift: float) -> np.ndarray:
    """mean -= delta_time * drift (nanopore.c:633-641). Returns a copy."""
    out = events.copy()
    out[:, 0] -= out[:, 3] * drift
    return out


def estimate_scalings_using_mom(kmer_ids: np.ndarray, model: PoreModel,
                                event_means: np.ndarray) -> ScalingParams:
    """Method-of-moments shift/scale from event and model level moments.

    reference: estimate_scalings_using_mom (eventAligner.c:790-840).
    """
    mu = model.level_mean[kmer_ids]
    shift = float(event_means.mean() - mu.mean())
    scale = float(((event_means - shift) ** 2).mean() / (mu ** 2).mean())
    return ScalingParams(shift=shift, scale=scale, drift=0.0, var=1.0)
