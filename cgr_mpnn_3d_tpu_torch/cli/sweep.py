"""Hyperparameter sweeps: the counterpart of ``cgr_mpnn_3d_tpu/cli/sweep.py``
over the port's ``cli/train.py``.

The sweep file (``hyperparameter_study/sweep_config.json``: ``values``,
``log_uniform_values`` and ``uniform`` parameters) is searched locally by
random sampling or a TPE (Tree-structured Parzen Estimator) sampler, chosen
by its ``method`` (``bayes`` -> TPE, ``random``).  The samplers are the JAX
package's numpy code, so a seed and the losses told give the same configs.
Every trial appends one JSON line to the study file (a failed trial is
recorded with ``status`` "failed" and the sweep goes on); the evaluator
ranks the trials by validation loss.  Each trial trains on ``--device``
(default ``cuda``), as ``cli/train.py`` does.

Usage:
  python -m cgr_mpnn_3d_tpu_torch.cli.sweep -p sweep_config.json -c 20 \
      [--study hyperparameter_study/sweep.jsonl] [--device cpu]
  python -m cgr_mpnn_3d_tpu_torch.cli.sweep --evaluate --study ...
"""

from __future__ import annotations

import argparse
import functools
import json
import time
from pathlib import Path

import numpy as np

__all__ = ["sample_config", "TPESampler", "run_sweep", "evaluate_sweep"]


def sample_config(space: dict, rng: np.random.Generator) -> dict:
    """Draw one trial from a sweep_config.json-style parameter space."""
    out = {}
    for name, spec in space.items():
        if "value" in spec:
            out[name] = spec["value"]
        elif "values" in spec:
            out[name] = spec["values"][int(rng.integers(len(spec["values"])))]
        elif spec.get("distribution") == "log_uniform_values":
            lo, hi = np.log(spec["min"]), np.log(spec["max"])
            out[name] = float(np.exp(rng.uniform(lo, hi)))
        elif spec.get("distribution") == "uniform":
            out[name] = float(rng.uniform(spec["min"], spec["max"]))
        else:
            raise ValueError(f"unsupported parameter spec for {name}: {spec}")
    return out


class TPESampler:
    """Tree-structured Parzen Estimator over a sweep_config space.

    After ``n_startup`` random trials, observed configs split into the top
    ``gamma`` fraction ("good") and the rest by loss; proposals are drawn
    from a Parzen mixture over the good observations and scored by the
    density ratio l(x)/g(x) -- the argmax of ``n_candidates`` draws wins.
    Categorical parameters use smoothed category counts.  Continuous
    parameters model in the transformed (log for log_uniform) space."""

    def __init__(self, space: dict, seed: int = 0, n_startup: int = 12,
                 gamma: float = 0.15, n_candidates: int = 48,
                 explore: float = 0.2):
        self.space = space
        self.rng = np.random.default_rng(seed)
        self.n_startup = n_startup
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.explore = explore      # epsilon of pure-random proposals:
                                    # prevents early categorical lock-in
        self._obs: list[tuple[dict, float]] = []

    def tell(self, config: dict, loss: float) -> None:
        if loss is not None and np.isfinite(loss):
            self._obs.append((config, float(loss)))

    # -- proposal ----------------------------------------------------------
    def ask(self) -> dict:
        if len(self._obs) < self.n_startup \
                or self.rng.random() < self.explore:
            return sample_config(self.space, self.rng)
        order = sorted(self._obs, key=lambda t: t[1])
        n_good = max(1, int(np.ceil(self.gamma * len(order))))
        good = [c for c, _ in order[:n_good]]
        bad = [c for c, _ in order[n_good:]] or good
        # canonical TPE: draw FULL candidate configs from l(x) and keep the
        # argmax of the joint log ratio sum_dim log l_d - log g_d (per-dim
        # argmaxing instead would over-exploit and lock in early luck)
        dims = {name: self._dim_model(name, spec, good, bad)
                for name, spec in self.space.items()}
        best_cfg, best_score = None, -np.inf
        for _ in range(self.n_candidates):
            cfg, score = {}, 0.0
            for name, (draw, log_ratio) in dims.items():
                cfg[name] = draw()
                score += log_ratio(cfg[name])
            if score > best_score:
                best_cfg, best_score = cfg, score
        return best_cfg

    def _dim_model(self, name, spec, good, bad):
        """-> (draw_from_l, log_ratio) for one parameter."""
        if "value" in spec:
            return (lambda: spec["value"]), (lambda v: 0.0)

        if "values" in spec:
            vals = spec["values"]
            keys = [repr(v) for v in vals]
            cg = np.ones(len(vals))
            cb = np.ones(len(vals))
            for c in good:
                cg[keys.index(repr(c[name]))] += 1
            for c in bad:
                cb[keys.index(repr(c[name]))] += 1
            log_r = np.log(cg / cg.sum()) - np.log(cb / cb.sum())
            # uniform-prior mixing keeps every category reachable
            p = 0.75 * cg / cg.sum() + 0.25 / len(vals)
            draw = lambda: vals[int(self.rng.choice(len(vals), p=p))]
            return draw, lambda v: float(log_r[keys.index(repr(v))])

        logspace = spec.get("distribution") == "log_uniform_values"
        tf = (lambda v: float(np.log(v))) if logspace else float
        lo, hi = tf(spec["min"]), tf(spec["max"])
        og = np.asarray([tf(c[name]) for c in good], float)
        ob = np.asarray([tf(c[name]) for c in bad], float)
        # Parzen bandwidth (Scott-style, floored to 1/20 of the range)
        bw = max((hi - lo) / 20.0,
                 (hi - lo) * 1.06 * max(len(og), 1) ** -0.2 / 4)

        def mix_logpdf(x, centers):
            d = (x - centers) / bw
            return float(np.log(np.mean(np.exp(-0.5 * d * d)) + 1e-300))

        def draw():
            c = og[int(self.rng.integers(0, len(og)))]
            x = float(np.clip(c + self.rng.normal(0.0, bw), lo, hi))
            return float(np.exp(x)) if logspace else x

        return draw, lambda v: (mix_logpdf(tf(v), og)
                                - mix_logpdf(tf(v), ob))


def run_sweep(sweep_config: dict, count: int, study_path: str | Path,
              seed: int = 0, train_fn=None,
              device: str = "cuda") -> list[dict]:
    """Run ``count`` trials; append one JSON line per trial to
    ``study_path``.  ``sweep_config['method']`` picks the sampler ('bayes'
    -> TPE, 'random' -> iid draws).  ``train_fn(config) -> result dict``
    defaults to training through ``cli/train.py`` on ``device``."""
    space = sweep_config["parameters"]
    method = sweep_config.get("method", "random")
    if method not in ("bayes", "random"):
        raise ValueError(f"unsupported sweep method {method!r}")
    rng = np.random.default_rng(seed)
    sampler = TPESampler(space, seed=seed) if method == "bayes" else None
    study_path = Path(study_path)
    study_path.parent.mkdir(parents=True, exist_ok=True)

    if train_fn is None:
        train_fn = functools.partial(_default_train_fn, device=device)

    results = []
    for trial in range(count):
        config = sampler.ask() if sampler else sample_config(space, rng)
        run_id = f"t{trial:03d}_{int(time.time())}"
        print(f"=== sweep trial {trial + 1}/{count} [{method}]: {config}")
        try:
            metrics = train_fn(config)
            status = "ok"
        except Exception as e:  # record and continue, like wandb agents
            metrics = {"error": str(e)}
            status = "failed"
        if sampler:
            sampler.tell(config, metrics.get("val_loss", float("inf")))
        rec = {"run_id": run_id, "status": status, "config": config,
               **{k: v for k, v in metrics.items()
                  if isinstance(v, (int, float, str, list))}}
        with open(study_path, "a") as f:
            f.write(json.dumps(rec, default=float) + "\n")
        results.append(rec)
    return results


# config key -> (arg attribute, converter).  Every key a sweep space may
# emit must appear here (or in _IGNORED_KEYS): unknown keys are an error, so
# a sweep over e.g. activation_fn can never silently do nothing.
_KEY_MAP = {
    "name": ("name", str),
    "depth": ("depth", int),
    "lr": ("learning_rate", float),
    "learning_rate": ("learning_rate", float),
    "num_epochs": ("num_epochs", int),
    "weight_decay": ("weight_decay", float),
    "batch_size": ("batch_size", int),
    "gamma": ("gamma", float),
    "learnable_skip": ("learnable_skip", bool),
    "activation_fn": ("activation_fn", str),
    "aggr": ("aggr", str),
    "data_path": ("data_path", str),
    "save_path": ("save_path", str),
    "seed": ("seed", int),
}
# keys of the original sweep files with no meaning here
_IGNORED_KEYS = {"gpu_id"}


def _default_train_fn(config: dict, device: str = "cuda") -> dict:
    """Train one trial's config through ``cli/train.py`` on ``device``
    (no test) -> its train and validation losses."""
    from .train import build_arg_parser, train

    args = build_arg_parser().parse_args([])
    unknown = (set(config) - set(_KEY_MAP) - _IGNORED_KEYS
               - {"hidden_sizes", "dropout_ps"})
    if unknown:
        raise ValueError(f"sweep config keys not understood by the trial "
                         f"runner: {sorted(unknown)}")
    for key, (attr, conv) in _KEY_MAP.items():
        if key in config:
            setattr(args, attr, conv(config[key]))
    # single-element lists broadcast across depth
    hs = config.get("hidden_sizes", [300])
    args.hidden_sizes = (hs * args.depth)[: args.depth] if len(hs) == 1 \
        else list(hs)
    dp = config.get("dropout_ps", [0.02])
    args.dropout_ps = (dp * args.depth)[: args.depth] if len(dp) == 1 \
        else list(dp)
    args.skip_test = True
    args.device = device
    result = train(args)
    return {"train_loss": result["train_losses"][-1],
            "val_loss": result["val_losses"][-1],
            "train_losses": result["train_losses"],
            "val_losses": result["val_losses"]}


def evaluate_sweep(study_path: str | Path,
                   output_file: str | None = None) -> list[dict]:
    """Rank the recorded trials by val_loss (failed trials last); print
    them and the best, and write them to ``output_file`` if given."""
    results = []
    with open(study_path) as f:
        for line in f:
            if line.strip():
                results.append(json.loads(line))
    results.sort(key=lambda r: r.get("val_loss")
                 if r.get("val_loss") is not None else float("inf"))

    print("\nSweep Evaluation Results:")
    for r in results:
        print(f"Run ID: {r['run_id']}, Train Loss: {r.get('train_loss')}, "
              f"Val Loss: {r.get('val_loss')}")
        print(f"Configuration: {r.get('config')}")
        print("-" * 50)
    if results:
        best = results[0]
        print("\nBest Run:")
        print(f"Run ID: {best['run_id']}, Train Loss: "
              f"{best.get('train_loss')}, Val Loss: {best.get('val_loss')}")
    if output_file:
        with open(output_file, "w") as f:
            json.dump(results, f, indent=4, default=float)
    return results


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description="Local hyperparameter sweep")
    ap.add_argument("-p", "--path_input_file",
                    default="hyperparameter_study/sweep_config.json")
    ap.add_argument("-c", "--count", default=20, type=int)
    ap.add_argument("--study", default="hyperparameter_study/sweep.jsonl")
    ap.add_argument("--seed", default=0, type=int)
    ap.add_argument("--evaluate", action="store_true",
                    help="only rank an existing study file")
    ap.add_argument("-o", "--output_file", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the device every trial trains on")
    args = ap.parse_args(argv)

    if args.evaluate:
        return evaluate_sweep(args.study, args.output_file)
    with open(args.path_input_file) as f:
        sweep_config = json.load(f)
    run_sweep(sweep_config, args.count, args.study, seed=args.seed,
              device=args.device)
    return evaluate_sweep(args.study, args.output_file)


if __name__ == "__main__":
    main()
