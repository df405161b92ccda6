"""The two kinds of cell a traffic file can name: ``fit`` and ``score``.

Each takes a cell (its configuration, traffic and limits), a seed, the
window's length and whether to trace, and runs set-up, the measured
window and the comparison, in that order, returning a :class:`Run` for
the metric readers and the numbers compared.  The program under test is
``repro_torch``: ``core.boosting.fit`` in the fit cells,
``GBDTModel.predict`` (margins) in the score cell.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from . import compare, counts, devtrace, forest as forest_lib, reference, \
    synth

SEED_DATA, SEED_FIT, SEED_FOREST, SEED_REQUESTS, SEED_CHECK = range(1, 6)


@dataclasses.dataclass
class Run:
    """What a run measured, for the metric readers."""
    kind: str
    setup_s: float = 0.0
    # fit: host seconds of each unprofiled fit in the window, rounds a fit
    fit_seconds: list = dataclasses.field(default_factory=list)
    rounds: int = 0
    # score: host seconds of each unprofiled request, and the window's
    # rows and seconds
    latencies: list = dataclasses.field(default_factory=list)
    window_rows: int = 0
    window_s: float = 0.0
    # the traced part (None without --trace) and what it covered
    trace: devtrace.Trace | None = None
    traced_rounds: int = 0
    # the work of a round / a histogram level / a request, from shapes
    work: dict = dataclasses.field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    numbers: dict = dataclasses.field(default_factory=dict)
    where: dict = dataclasses.field(default_factory=dict)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _warm_profiler(device) -> None:
    """Start the profiler's device tracing once before the window."""
    if torch.device(device).type == "cuda":
        devtrace.profiled(lambda: torch.ones(1, device=device).add_(1))


class FitCell:
    """Whole ``fit`` calls back to back on one table."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from repro_torch.core import boosting
        self.boosting = boosting
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.model = dict(config["model"])
        self.strategy = traffic["strategy"]
        self.k = traffic["n_candidates"]
        self.cfg = boosting.GBDTConfig(
            n_trees=self.model["n_trees"], max_depth=self.model["max_depth"],
            learning_rate=self.model["learning_rate"], l2=self.model["l2"],
            gamma=self.model["gamma"],
            min_child_weight=self.model["min_child_weight"],
            n_candidates=self.k, strategy=self.strategy,
            objective=self.model["objective"],
            repropose_each_round=traffic["repropose_each_round"])
        self.models: list = []

    def _generator(self, i: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            synth.sub_seed(self.seed, SEED_FIT, i))

    def setup(self, trace: bool) -> None:
        gen = self.config["generator"]
        self.x, self.y = synth.classification(
            self.config["train_rows"], self.config["features"],
            synth.sub_seed(self.seed, SEED_DATA), self.device,
            sep=gen["sep"], flip=gen["flip"])
        warm = dataclasses.replace(self.cfg,
                                   n_trees=self.traffic["warmup_rounds"])
        self.boosting.fit(self.x, self.y, warm, self._generator(1 << 20),
                          device=self.device)
        if trace:
            _warm_profiler(self.device)
        _sync(self.device)

    def _fit(self, i: int):
        model = self.boosting.fit(self.x, self.y, self.cfg, self._generator(i),
                                  device=self.device)
        self.models.append(model)
        return model

    def window(self, seconds: float, trace: bool, run: Run) -> None:
        n, f = self.x.shape
        run.rounds = self.cfg.n_trees
        run.work = {
            "round": counts.fit_round(n, f, self.k, self.cfg.max_depth,
                                      self.strategy),
            "hist_tree": counts.hist_tree(n, f, self.k + 1,
                                          self.cfg.max_depth)}
        t0 = time.perf_counter()
        i = 0
        while (i == 0 or time.perf_counter() - t0 < seconds
               or (trace and i < 2)):
            if trace and i == 1:
                _, run.trace = devtrace.profiled(lambda: self._fit(1))
                run.traced_rounds = self.cfg.n_trees
            else:
                a = time.perf_counter()
                self._fit(i)     # fit synchronises before it returns
                run.fit_seconds.append(time.perf_counter() - a)
            i += 1
        run.attempted = len(self.models)

    def free(self) -> None:
        """Drop what the program holds on the card but its answers."""
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def judge(self, run: Run) -> None:
        rng = np.random.default_rng(synth.sub_seed(self.seed, SEED_CHECK))
        picks = rng.choice(len(self.models),
                           size=min(self.traffic["check"]["fits"],
                                    len(self.models)), replace=False)
        numbers: dict = {}
        for i in sorted(picks):
            model = self.models[int(i)]
            fo = model.forest
            got, where = compare.fit_numbers(
                self.x, self.y,
                {"feature": fo.feature, "split_bin": fo.split_bin,
                 "threshold": fo.threshold, "leaf_value": fo.leaf_value,
                 "candidates": model.candidates},
                self.model, strategy=self.strategy, k=self.k,
                repropose=self.cfg.repropose_each_round)
            run.failed += 0 if compare.held(got, self.limits) else 1
            compare.merge(numbers, got)
            run.where.update({key: dict(value, fit=int(i))
                              for key, value in where.items()})
        run.numbers = numbers


class ScoreCell:
    """Batch scoring of row blocks of a table on the card by one client in
    a closed loop: each request is sent when the last has returned."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from repro_torch.checkpoint import model_from_numpy
        self.model_from_numpy = model_from_numpy
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.spec = traffic["forest"]
        self.rows = traffic["rows_per_request"]
        self.kept: dict[int, torch.Tensor] = {}

    def setup(self, trace: bool) -> None:
        gen = self.config["generator"]
        self.table, _ = synth.classification(
            self.config["rows"], self.config["features"],
            synth.sub_seed(self.seed, SEED_DATA), self.device,
            sep=gen["sep"], flip=gen["flip"])
        self.forest = forest_lib.arrays(
            self.table, self.spec, synth.sub_seed(self.seed, SEED_FOREST))
        settings = dict(n_trees=self.spec["n_trees"],
                        max_depth=self.spec["max_depth"],
                        n_candidates=self.spec["n_candidates"],
                        learning_rate=self.spec["learning_rate"],
                        repropose_each_round=False)
        self.program = self.model_from_numpy(
            self.forest, settings, self.spec["base_score"], self.device)
        rng = np.random.default_rng(synth.sub_seed(self.seed, SEED_REQUESTS))
        self.offsets = rng.integers(0, self.table.shape[0] - self.rows + 1,
                                    size=self.traffic["max_requests"])
        for i in range(self.traffic["warmup_requests"]):
            self._request(i)
        if trace:
            _warm_profiler(self.device)
        _sync(self.device)

    def _request(self, i: int) -> torch.Tensor:
        off = int(self.offsets[i % len(self.offsets)])
        out = self.program.predict(self.table[off:off + self.rows],
                                   output="margin")
        _sync(self.device)
        return out

    def window(self, seconds: float, trace: bool, run: Run) -> None:
        f = self.table.shape[1]
        run.work = {"request": counts.forest_request(
            self.rows, f, self.spec["n_trees"], self.spec["max_depth"])}
        want = self.traffic["check"]["requests"]
        pick = np.random.default_rng(synth.sub_seed(self.seed, SEED_CHECK))
        first, count = self.traffic["trace_after"], \
            self.traffic["trace_requests"]
        t0 = time.perf_counter()
        i = 0
        while (i == 0 or time.perf_counter() - t0 < seconds
               or (trace and i < first + count)):
            if trace and i == first:
                def block():
                    return [self._request(j) for j in range(i, i + count)]
                outs, run.trace = devtrace.profiled(block)
            else:
                a = time.perf_counter()
                outs = [self._request(i)]
                run.latencies.append(time.perf_counter() - a)
            for out in outs:           # a seeded reservoir of the answers
                if len(self.kept) < want:
                    self.kept[i] = out
                elif pick.random() < want / (i + 1):
                    del self.kept[sorted(self.kept)[int(pick.integers(want))]]
                    self.kept[i] = out
                i += 1
        run.window_s = time.perf_counter() - t0
        run.window_rows = i * self.rows
        run.attempted = i

    def free(self) -> None:
        del self.program
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def judge(self, run: Run) -> None:
        numbers: dict = {}
        for i, got in sorted(self.kept.items()):
            off = int(self.offsets[i % len(self.offsets)])
            n, where = compare.score_numbers(
                self.table[off:off + self.rows], got, self.forest, self.spec)
            run.failed += 0 if compare.held(n, self.limits) else 1
            compare.merge(numbers, n)
            if n["margin_gap"] >= numbers["margin_gap"]:
                run.where = dict(where, request=i)
        run.numbers = numbers


KINDS = {"fit": FitCell, "score": ScoreCell}


def execute(cell: dict, seed: int, seconds: float, trace: bool, device,
            t_start: float, before_judge=None) -> Run:
    """Set up, measure and judge one run of ``cell`` (from
    ``harness.load_cell``).  ``before_judge(run)`` runs once the window has
    closed and before the program's state is freed (the harness reads the
    memory peak there)."""
    cell_run = KINDS[cell["traffic"]["kind"]](
        cell["config"], cell["traffic"], seed, device)
    cell_run.limits = cell["limits"]
    run = Run(kind=cell["traffic"]["kind"])
    cell_run.setup(trace)
    run.setup_s = time.perf_counter() - t_start
    cell_run.window(seconds, trace, run)
    if before_judge is not None:
        before_judge(run)
    cell_run.free()
    cell_run.judge(run)
    return run


def control_numbers(cell: dict, seed: int, device) -> dict:
    """The control of ``cell`` on ``seed``: the plain reference in
    bfloat16 in the program's place, judged as the program is."""
    config, traffic = cell["config"], cell["traffic"]
    gen = config["generator"]
    if traffic["kind"] == "fit":
        x, y = synth.classification(
            config["train_rows"], config["features"],
            synth.sub_seed(seed, SEED_DATA), device, sep=gen["sep"],
            flip=gen["flip"])
        g = torch.Generator(device=device).manual_seed(
            synth.sub_seed(seed, SEED_FIT, 0))
        fitted = reference.fit(x, y, config["model"],
                               strategy=traffic["strategy"],
                               k=traffic["n_candidates"], generator=g,
                               dtype=torch.bfloat16)
        return compare.fit_numbers(
            x, y, fitted, config["model"], strategy=traffic["strategy"],
            k=traffic["n_candidates"],
            repropose=traffic["repropose_each_round"])[0]
    table, _ = synth.classification(
        config["rows"], config["features"], synth.sub_seed(seed, SEED_DATA),
        device, sep=gen["sep"], flip=gen["flip"])
    spec, rows = traffic["forest"], traffic["rows_per_request"]
    arrays = forest_lib.arrays(table, spec,
                               synth.sub_seed(seed, SEED_FOREST))
    rng = np.random.default_rng(synth.sub_seed(seed, SEED_REQUESTS))
    numbers: dict = {}
    for off in rng.integers(0, table.shape[0] - rows + 1,
                            size=traffic["check"]["requests"]):
        x = table[int(off):int(off) + rows]
        got = reference.margins(
            x, *(torch.as_tensor(arrays[f"forest/{key}"], device=device)
                 for key in ("feature", "threshold", "leaf_value")),
            base=spec["base_score"], learning_rate=spec["learning_rate"],
            depth=spec["max_depth"], dtype=torch.bfloat16)
        compare.merge(numbers, compare.score_numbers(x, got, arrays,
                                                     spec)[0])
    return numbers
