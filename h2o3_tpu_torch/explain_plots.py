"""Explanation figures of the port (h2o3_tpu/explain_plots.py, h2o-py's
h2o/explanation/_explain.py): SHAP summaries and row explanations,
partial dependence, ICE, variable importance, learning curves and the
cross-model heatmaps, bundled by ``explain``. TreeSHAP contributions come
from ``predict_contributions``, the tables from
``h2o3_tpu_torch.explain_data``.

matplotlib is imported at the first figure, with the Agg backend, not
when this module is imported: the package and explain_data work on a
machine without it. Every function returns a ``matplotlib.figure.Figure``
made outside pyplot's registry (a long-lived process must not gather
figures) and never calls ``plt.show()``.

Style: one restrained categorical blue for magnitude bars, a blue-orange
diverging scale with a neutral gray midpoint for signed feature values,
recessive grids, horizontal bars for ranked importances.
"""

from __future__ import annotations

import numpy as np

from h2o3_tpu_torch import explain_data as _ex
from h2o3_tpu_torch.core.frame import Frame
from h2o3_tpu_torch.core.kvstore import DKV

_BLUE = "#4477aa"
_ORANGE = "#ee7733"
_GRAY = "#bbbbbb"
_MPL = {}


def _mpl():
    """matplotlib's pieces, imported once (Agg), and the diverging map:
    two hues and a neutral midpoint (never a hue at the centre)."""
    if not _MPL:
        try:
            import matplotlib
        except ImportError as e:
            raise ImportError(
                "the explanation figures need matplotlib; the tables are "
                "in h2o3_tpu_torch.explain_data") from e
        matplotlib.use("Agg")
        import matplotlib.cm as cm
        from matplotlib.colors import LinearSegmentedColormap
        from matplotlib.figure import Figure
        _MPL.update(cm=cm, Figure=Figure,
                    diverging=LinearSegmentedColormap.from_list(
                        "h2o3_div", [_BLUE, "#c8c8c8", _ORANGE]))
    return _MPL


def _fig(figsize):
    fig = _mpl()["Figure"](figsize=figsize)
    return fig, fig.add_subplot()


def _style(ax):
    ax.grid(True, axis="both", color="#e6e6e6", linewidth=0.6, zorder=0)
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)


def _contributions(model, frame: Frame):
    """(n, k) contribution matrix + feature names (BiasTerm dropped)."""
    cf = model.predict_contributions(frame)
    names = [c for c in cf.names if c != "BiasTerm"]
    M = np.column_stack([cf.vec(c).to_numpy() for c in names])
    DKV.remove(cf.key)
    return M, names


def _feature_matrix(model, frame: Frame, names):
    cols = []
    for c in names:
        v = frame.vec(c)
        x = v.to_numpy().astype(np.float64)
        cols.append(x)
    return np.column_stack(cols)


def shap_summary_plot(model, frame: Frame, top_n: int = 20,
                      sample_size: int = 1000, figsize=(9, 6)):
    """Beeswarm of per-row SHAP contributions, one strip per feature,
    colored by normalized feature value (reference shap_summary_plot)."""
    n = min(frame.nrows, sample_size)
    sub = frame if frame.nrows == n else _sample_frame(frame, n)
    M, names = _contributions(model, sub)
    X = _feature_matrix(model, sub, names)
    if sub is not frame:
        DKV.remove(sub.key)
    order = np.argsort(np.abs(M).mean(0))[::-1][:top_n]
    fig, ax = _fig(figsize)
    rng = np.random.default_rng(0)
    for pos, j in enumerate(order[::-1]):
        x = M[:, j]
        fv = X[:, j]
        lo, hi = np.nanmin(fv), np.nanmax(fv)
        cv = (fv - lo) / (hi - lo) if hi > lo else np.full_like(fv, 0.5)
        cv = np.nan_to_num(cv, nan=0.5)
        jitter = rng.normal(0, 0.08, len(x))
        ax.scatter(x, pos + jitter, c=cv, cmap=_mpl()["diverging"], s=9,
                   linewidths=0, alpha=0.8, zorder=3)
    ax.set_yticks(range(len(order)))
    ax.set_yticklabels([names[j] for j in order[::-1]])
    ax.axvline(0, color="#888888", linewidth=0.8, zorder=2)
    ax.set_xlabel("SHAP contribution")
    ax.set_title(f"SHAP summary — {model.model_id}")
    sm = _mpl()["cm"].ScalarMappable(cmap=_mpl()["diverging"])
    cb = fig.colorbar(sm, ax=ax, ticks=[0, 1])
    cb.ax.set_yticklabels(["low", "high"])
    cb.set_label("feature value")
    _style(ax)
    fig.tight_layout()
    return fig


def shap_explain_row_plot(model, frame: Frame, row_index: int,
                          top_n: int = 10, figsize=(9, 5)):
    """Signed contribution bars for ONE row (reference
    shap_explain_row_plot)."""
    sub = _slice_rows(frame, [row_index])
    M, names = _contributions(model, sub)
    X = _feature_matrix(model, sub, names)
    DKV.remove(sub.key)
    vals = M[0]
    order = np.argsort(np.abs(vals))[::-1][:top_n][::-1]
    fig, ax = _fig(figsize)
    colors = [_ORANGE if vals[j] > 0 else _BLUE for j in order]
    ax.barh(range(len(order)), vals[order], color=colors, height=0.62,
            zorder=3)
    ax.set_yticks(range(len(order)))
    ax.set_yticklabels([f"{names[j]} = {X[0, j]:.4g}" for j in order])
    ax.axvline(0, color="#888888", linewidth=0.8)
    ax.set_xlabel("SHAP contribution")
    ax.set_title(f"SHAP row {row_index} — {model.model_id}")
    _style(ax)
    fig.tight_layout()
    return fig


def pd_plot(model, frame: Frame, column: str, nbins: int = 20,
            figsize=(8, 5)):
    """Partial-dependence line (numeric) or bars (categorical) with the
    mean-response reference line (reference pd_plot)."""
    pd_data = _ex.partial_dependence(model, frame, column, nbins)
    grid, pd_vals = pd_data["grid"], pd_data["mean_response"]
    fig, ax = _fig(figsize)
    if isinstance(grid[0], str):
        ax.bar(range(len(grid)), pd_vals, color=_BLUE, width=0.62, zorder=3)
        ax.set_xticks(range(len(grid)))
        ax.set_xticklabels(grid, rotation=30, ha="right")
    else:
        ax.plot(grid, pd_vals, color=_BLUE, linewidth=2, zorder=3)
        # data-density rug
        x = frame.vec(column).to_numpy()
        x = x[~np.isnan(x)][:1000]
        ax.plot(x, np.full(len(x), ax.get_ylim()[0]), "|",
                color="#888888", markersize=5, alpha=0.4)
    ax.set_xlabel(column)
    ax.set_ylabel("mean response")
    ax.set_title(f"Partial dependence — {column}")
    _style(ax)
    fig.tight_layout()
    return fig


def ice_plot(model, frame: Frame, column: str, nbins: int = 20,
             n_rows: int = 30, figsize=(8, 5)):
    """Individual conditional expectation curves + the PD centerline."""
    frac = min(1.0, n_rows / max(frame.nrows, 1))
    grid, curves = _ex.ice(model, frame, column, nbins, frac)
    fig, ax = _fig(figsize)
    for c in curves:
        ax.plot(grid, c, color=_GRAY, linewidth=0.7, alpha=0.6, zorder=2)
    ax.plot(grid, np.mean(curves, axis=0), color=_ORANGE, linewidth=2.4,
            zorder=3, label="mean (PD)")
    ax.legend(frameon=False)
    ax.set_xlabel(column)
    ax.set_ylabel("response")
    ax.set_title(f"ICE — {column}")
    _style(ax)
    fig.tight_layout()
    return fig


def varimp_plot(model, num_of_features: int = 10, figsize=(8, 5)):
    """Ranked scaled-importance bars (reference varimp_plot)."""
    vi = model.varimp()
    if not vi:
        raise ValueError(f"{model.algo} has no variable importances")
    vi = vi[:num_of_features][::-1]
    fig, ax = _fig(figsize)
    ax.barh([r["variable"] for r in vi],
            [r["scaled_importance"] for r in vi],
            color=_BLUE, height=0.62, zorder=3)
    ax.set_xlabel("scaled importance")
    ax.set_title(f"Variable importance — {model.model_id}")
    _style(ax)
    fig.tight_layout()
    return fig


def learning_curve_plot(model, metric: str = "AUTO", figsize=(8, 5)):
    """Training/validation series from the scoring history."""
    data = _ex.learning_curve(model)
    if not data:
        raise ValueError("model has no scoring history")
    fig, ax = _fig(figsize)
    series = data["series"]
    if metric != "AUTO":
        series = {k: v for k, v in series.items() if k.endswith(metric)}
    palette = [_BLUE, _ORANGE, "#228833", "#aa3377"]
    for i, (k, v) in enumerate(sorted(series.items())):
        vals = [np.nan if x is None else x for x in v]
        ax.plot(data["x"], vals, label=k,
                color=palette[i % len(palette)], linewidth=2)
    if len(series) > 1:
        ax.legend(frameon=False, fontsize=8)
    ax.set_xlabel("iterations")
    ax.set_title(f"Learning curve — {model.model_id}")
    _style(ax)
    fig.tight_layout()
    return fig


def varimp_heatmap(models, figsize=(8, 5)):
    """Feature × model heatmap of scaled importances (sequential, one
    hue light→dark)."""
    feats, names, M = _ex.varimp_heatmap(models)
    fig, ax = _fig(figsize)
    im = ax.imshow(M, cmap="Blues", aspect="auto", vmin=0, vmax=1)
    ax.set_xticks(range(len(names)))
    ax.set_xticklabels(names, rotation=30, ha="right", fontsize=8)
    ax.set_yticks(range(len(feats)))
    ax.set_yticklabels(feats, fontsize=8)
    fig.colorbar(im, ax=ax, label="scaled importance")
    ax.set_title("Variable importance heatmap")
    fig.tight_layout()
    return fig


def model_correlation_heatmap(models, frame: Frame, figsize=(7, 6)):
    """Model × model prediction-correlation heatmap."""
    names, C = _ex.model_correlation(models, frame)
    fig, ax = _fig(figsize)
    im = ax.imshow(C, cmap=_mpl()["diverging"], vmin=-1, vmax=1)
    ax.set_xticks(range(len(names)))
    ax.set_xticklabels(names, rotation=30, ha="right", fontsize=8)
    ax.set_yticks(range(len(names)))
    ax.set_yticklabels(names, fontsize=8)
    for i in range(len(names)):
        for j in range(len(names)):
            ax.text(j, i, f"{C[i, j]:.2f}", ha="center", va="center",
                    fontsize=7, color="#333333")
    fig.colorbar(im, ax=ax, label="prediction correlation")
    ax.set_title("Model correlation")
    fig.tight_layout()
    return fig


# ---------------------------------------------------------------------------
def explain(models, frame: Frame, columns: int = 3,
            include_explanations=None, render: bool = False):
    """h2o.explain analog: ordered dict of figures (and data) per the
    reference's explanation plan — leaderboard-style correlation + varimp
    heatmap for multi-model input; SHAP summary, varimp, PDP and learning
    curve for a single model. ``render=False`` returns the figures."""
    models = models if isinstance(models, (list, tuple)) else [models]
    out = {}
    m0 = models[0]
    if len(models) > 1:
        out["model_correlation_heatmap"] = model_correlation_heatmap(
            models, frame)
        with_vi = [m for m in models if m.varimp()]
        if len(with_vi) > 1:
            out["varimp_heatmap"] = varimp_heatmap(with_vi)
    if m0.varimp():
        out["varimp_plot"] = varimp_plot(m0)
        top = [r["variable"] for r in m0.varimp()[:columns]]
    else:
        top = list(m0._dinfo.feature_names[:columns])
    if hasattr(m0, "predict_contributions"):
        try:
            out["shap_summary_plot"] = shap_summary_plot(m0, frame)
        except Exception:        # noqa: BLE001 — SHAP needs tree models
            pass
    out["pd_plots"] = {
        c: pd_plot(m0, frame, c)
        for c in top if c in m0._dinfo.predictors}
    try:
        out["learning_curve_plot"] = learning_curve_plot(m0)
    except ValueError:
        pass
    return out


def explain_row(models, frame: Frame, row_index: int, columns: int = 3):
    """h2o.explain_row analog: per-row SHAP bars + ICE curves."""
    models = models if isinstance(models, (list, tuple)) else [models]
    m0 = models[0]
    out = {}
    if hasattr(m0, "predict_contributions"):
        try:
            out["shap_explain_row_plot"] = shap_explain_row_plot(
                m0, frame, row_index)
        except Exception:        # noqa: BLE001
            pass
    if m0.varimp():
        top = [r["variable"] for r in m0.varimp()[:columns]]
    else:
        top = list(m0._dinfo.feature_names[:columns])
    out["ice_plots"] = {c: ice_plot(m0, frame, c)
                        for c in top if c in m0._dinfo.predictors}
    return out


# ---------------------------------------------------------------------------
def _sample_frame(frame: Frame, n: int) -> Frame:
    idx = np.random.default_rng(0).choice(frame.nrows, n, replace=False)
    return _slice_rows(frame, np.sort(idx))


def _slice_rows(frame: Frame, rows) -> Frame:
    from h2o3_tpu_torch.rapids.rapids import rapids_exec
    lst = " ".join(str(int(i)) for i in rows)
    out = rapids_exec(f"(rows {frame.key} [{lst}])")
    return out
