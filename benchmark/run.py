"""The benchmark of ``tpu_ac_torch``: one cell of ``BENCHMARK.json``, once.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

Set-up writes the cell's MVTec-layout tree of seeded PNGs (under
``$TMPDIR``, removed at exit) while it makes the backbone's weights on the
card from the seed and loads them into the registry's module, then warms
the shapes the window uses: a sweep over one category of each size class
of alpha (every embed batch is padded to the batch size, so it has one
shape).  The window then runs whole sweeps of
``tpu_ac_torch.pipeline.run_category_sweep`` over the mix's categories,
back to back, starting sweeps until ``--seconds`` have passed and
finishing the one that runs; a category is done when its (alpha, X) is on
the host.  On the card the window runs under ``torch.profiler``: with
``--trace 0`` CUPTI's device activity alone, from which ``sweep_busy_s``
(the card's busy seconds a whole sweep) is read beside ``peak_mem_gib``
and ``setup_s``; with ``--trace 1`` the host's ops too, and the run reports
the per-layer metrics instead of the end-to-end ones.  After the
window the program is freed and the plain reference
(``benchmark/reference``) recomputes the categories drawn from the seed;
``harness/check.py`` compares.  The last line of standard output is the
result (JSON); the numbers compared, beside their limits, are the last
lines of standard error.

Exit codes: 0 with a result; 2 for a workload the manifest lacks; 3 where
there is no card or fewer cards than the cell asks for; 4 where the
program is not in the checkout; 5 where a forbidden module (``jax``,
``jaxlib``, ``flax``, ``tpu_ac``) was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from concurrent.futures import ThreadPoolExecutor  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark.harness import check as check_mod  # noqa: E402
from benchmark.harness import manifest, traffic, tracewin  # noqa: E402
from benchmark.harness.peaks import least_s  # noqa: E402
from benchmark.harness.weights import make_weights  # noqa: E402
from benchmark.reference import fp8 as ref_fp8  # noqa: E402
from benchmark.reference import pipeline as ref_pipeline  # noqa: E402

GIB = 2 ** 30
# compute_alpha_X pads a category's N to a multiple of this (its n_bucket)
ALPHA_BUCKET = 32


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them
    (``tpu_ac_torch.device.CARD_QUERY``)."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def keep_caches_in(root: str) -> None:
    """Every build and kernel cache under the checkout, at fixed paths
    (the port builds its kernels into ``build/tpu_ac_torch`` there)."""
    base = os.path.join(root, "build", "bench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(base, sub)
    os.environ["USE_FLAX"] = "0"


class Work:
    """The window's work as the benchmark reckons it from the shapes."""

    def __init__(self, cell: manifest.Cell, mix: traffic.Mix):
        flops = manifest.config_module(cell, "flops")
        cfg = cell.config
        self.p = flops.patches(cfg, mix.imagesize)
        self.d = cfg["target_embed_dimension"]
        img = flops.image_flops(cfg, mix.imagesize)
        self.test_images = self.embed_flops = 0.0
        self.md_flops = self.md_least_s = 0.0
        for _, n in mix.categories:
            nt = mix.n_train(n)
            self.test_images += n
            self.embed_flops += (n + nt) * img
            if mix.mode == "supervised":
                pairs, in_imgs, outs = n * nt, n + nt, n * nt
            else:
                pairs, in_imgs, outs = n * (n - 1) // 2, n, n * n
            f = 2.0 * pairs * self.p * self.p * self.d
            self.md_flops += f
            self.md_least_s += least_s(f, 4.0 * in_imgs * self.p * self.d,
                                       4.0 * outs * self.p)[0]

    def of(self, sweeps: int) -> dict:
        return {"test_images": sweeps * self.test_images,
                "embed_flops": sweeps * self.embed_flops,
                "min_dists_flops": sweeps * self.md_flops,
                "min_dists_least_s": sweeps * self.md_least_s}


class Program:
    """The system under test, built for the cell: the registry's module
    with the benchmark's weights, in a ``CategoryEmbedder``."""

    def __init__(self, cell: manifest.Cell, mix: traffic.Mix, weights,
                 device):
        from tpu_ac_torch import pipeline
        from tpu_ac_torch.models.registry import (
            BACKBONE_CONFIGS,
            build_on_meta,
        )

        cfg = cell.config
        spec = BACKBONE_CONFIGS[cfg["backbone"]]
        for key, want in cfg["arch"].items():
            have = getattr(spec.config, key, None)
            have = list(have) if isinstance(have, tuple) else have
            if have != want:
                raise ValueError(f"{cfg['backbone']}: {key} is {have} in "
                                 f"the registry, {want} in the config")
        self.pipeline = pipeline
        model = build_on_meta(cfg["backbone"]).to_empty(device=device)
        if hasattr(model, "reset_buffers"):
            model.reset_buffers()
        model.load_state_dict(weights, strict=True)
        model.eval().requires_grad_(False)
        self.cfg = pipeline.PipelineConfig(
            backbone_name=cfg["backbone"], layers=tuple(cfg["layers"]),
            pretrain_embed_dimension=cfg["pretrain_embed_dimension"],
            target_embed_dimension=cfg["target_embed_dimension"],
            patchsize=cfg["patchsize"], tau=cfg["tau"],
            train_ratio=mix.train_ratio, supervised=mix.mode,
            resize=mix.resize, imagesize=mix.imagesize,
            batch_size=cfg["batch_size"], precision=cfg["precision"],
            alpha_precision=cfg["alpha_precision"])
        self.embedder = pipeline.CategoryEmbedder(
            model, self.cfg, device=device,
            attention_impl=cfg["attention_impl"], mesh=None)
        self.mix = mix

    def sweep(self, tree: str, names: list[str] | None = None):
        return self.pipeline.run_category_sweep(
            tree, self.mix.names if names is None else names, self.cfg,
            self.embedder, output_dir=None, seed=self.mix.train_seed)


def warm_categories(mix: traffic.Mix) -> list[str]:
    """The largest category of each size class that alpha takes (N padded
    to ``ALPHA_BUCKET``), in the mix's order: a sweep over them runs every
    shape of the window, and allocates its largest blocks."""
    largest: dict[int, tuple[int, str]] = {}
    for cat, n in mix.categories:
        k = -(-n // ALPHA_BUCKET)
        largest[k] = max(largest.get(k, (0, "")), (n, cat))
    keep = {cat for _, cat in largest.values()}
    return [c for c in mix.names if c in keep]


class Window:
    """Whole sweeps for ``seconds``; the drawn categories' answers kept."""

    def __init__(self):
        self.sweeps = 0
        self.attempted = 0
        self.failed = 0
        self.bad = 0
        self.answers: dict = {}
        self.elapsed = 0.0
        self.sweep_s: list[float] = []
        self.errors: list[str] = []


def run_window(program: Program, tree: str, seconds: float,
               sample: list[str], p: int, d: int) -> Window:
    from torch.profiler import record_function

    w = Window()
    sizes = dict(program.mix.categories)
    t0 = time.perf_counter()
    while True:
        done = 0
        ts = time.perf_counter()
        try:
            with record_function("bench.sweep"):
                for cat, res in program.sweep(tree):
                    done += 1
                    alpha, x = res["alpha"], res["X"]
                    fault = check_mod.answer_fault(alpha, x, sizes[cat], p,
                                                   d)
                    if fault:
                        w.bad += 1
                        w.errors.append(f"sweep {w.sweeps} {cat}: {fault}")
                    if cat in sample:
                        w.answers[(w.sweeps, cat)] = (np.array(alpha),
                                                      np.array(x))
        except Exception:  # a category that raises fails; the window ends
            w.errors.append(traceback.format_exc())
            w.failed += len(sizes) - done
            w.attempted += len(sizes)
            break
        w.attempted += len(sizes)
        w.sweeps += 1
        w.sweep_s.append(time.perf_counter() - ts)
        if time.perf_counter() - t0 >= seconds:
            break
    w.elapsed = time.perf_counter() - t0
    return w


@contextlib.contextmanager
def traced(trace: int, is_cuda: bool):
    """The window under ``torch.profiler``: with ``trace`` the host's ops
    and, on the card, CUPTI's device activity; without it the device
    activity alone, and nothing off the card.  Yields a list that holds the
    profiler once it has stopped."""
    if not trace and not is_cuda:
        yield []
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] if trace else []
    if is_cuda:
        acts.append(ProfilerActivity.CUDA)
    box = []
    with profile(activities=acts) as prof:
        with record_function(tracewin.WINDOW_RANGE):
            yield box
    box.append(prof)


def reference_answers(cell: manifest.Cell, mix: traffic.Mix, tree: str,
                      weights: dict, sample: list[str], device, q
                      ) -> dict:
    backbone = manifest.config_module(cell, "reference")
    w32 = {k: v.to(device=device, dtype=torch.float32)
           for k, v in weights.items()}
    return {cat: ref_pipeline.category(tree, cat, mix, cell.config, w32,
                                       backbone, device, q)
            for cat in sample}


def since(t: float) -> str:
    now = time.perf_counter()
    return f"{now - t:.2f} s (at {now - T_START:.2f} s)"


def prepare(cell: manifest.Cell, seed: int, device, tree: str,
            writing=None, warm: bool = True):
    """Set-up: the tree (``writing``: a future of ``traffic.write_tree``
    already started, or None to write it here), the weights, the program,
    and with ``warm`` a sweep over ``warm_categories``, which warms every
    shape and the allocators' largest blocks as the window will find
    them."""
    mix = traffic.Mix.from_dict(cell.traffic)
    t0 = time.perf_counter()
    if writing is None:
        log(f"tree: {traffic.write_tree(tree, mix, seed) / 2**20:.1f} MiB "
            f"of PNGs in {since(t0)}")
    t = time.perf_counter()
    backbone = manifest.config_module(cell, "reference")
    weights = make_weights(backbone.param_spec(cell.config), seed, device,
                           getattr(torch, cell.config["weights_dtype"]))
    log(f"weights: {since(t)}")
    t = time.perf_counter()
    program = Program(cell, mix, weights, device)
    work = Work(cell, mix)
    log(f"program: {since(t)}")
    if writing is not None:
        log(f"tree: {writing.result() / 2**20:.1f} MiB of PNGs, written "
            f"beside the set-up, ready {since(t0)}")
    if warm:
        t = time.perf_counter()
        names = warm_categories(mix)
        for _ in program.sweep(tree, names):
            pass
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        log(f"warm-up over {', '.join(names)}: {since(t)}")
    return mix, weights, program, work


def free_program(program: Program, is_cuda: bool) -> None:
    program.embedder = None
    gc.collect()
    if is_cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def main(argv=None, *, root: str = ROOT, device: str | None = None,
         control: bool = False) -> int:
    """One run; the exit code.  ``device="cpu"`` (tests only) skips the
    look for a card; ``control`` puts the precision control (the reference
    in fp8) in the program's place after the window."""
    args = parse_args(argv)
    try:
        cell = manifest.load_cell(args.workload, root)
    except KeyError as e:
        log(f"error: {e}")
        return 2
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            log(f"error: the cell needs {cell.chips} CUDA card(s); "
                f"torch.cuda.is_available() is "
                f"{torch.cuda.is_available()}, device_count "
                f"{torch.cuda.device_count()}")
            return 3
        device = "cuda"
    is_cuda = device == "cuda"
    keep_caches_in(root)
    mix = traffic.Mix.from_dict(cell.traffic)
    tree = tempfile.mkdtemp(prefix="bench-tree-")
    try:
        # the tree is written on threads while the program loads
        with ThreadPoolExecutor(1) as bg:
            writing = bg.submit(traffic.write_tree, tree, mix, args.seed)
            try:
                import tpu_ac_torch.pipeline  # noqa: F401
            except ImportError as e:
                log(f"error: the program tpu_ac_torch is not in this "
                    f"checkout: {e}")
                return 4
            if is_cuda:
                log(f"card: {card_line()}; torch {torch.__version__}, CUDA "
                    f"{torch.version.cuda}; imports done at "
                    f"{time.perf_counter() - T_START:.2f} s")
            return _run(cell, args, device, is_cuda, tree, control,
                        writing)
    finally:
        shutil.rmtree(tree, ignore_errors=True)


def _run(cell, args, device, is_cuda, tree, control, writing) -> int:
    mix, weights, program, work = prepare(cell, args.seed, device, tree,
                                          writing)
    sample = traffic.check_sample(mix, args.seed)
    if is_cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - T_START
    with traced(args.trace, is_cuda) as box:
        win = run_window(program, tree, args.seconds, sample, work.p,
                         work.d)
    window_peak = torch.cuda.max_memory_allocated() if is_cuda else 0
    free_program(program, is_cuda)
    done = work.of(win.sweeps)
    log(f"window: {win.sweeps} sweeps, {win.attempted} categories, "
        f"{win.failed} failed, {win.bad} malformed, {win.elapsed:.3f} s "
        f"({done['test_images'] / max(win.elapsed, 1e-9):.1f} test images "
        f"a second, which the host paces); sweeps of "
        f"{', '.join(f'{t:.3f}' for t in win.sweep_s)} s")
    for err in win.errors[:5]:
        log(err)
    if args.trace:
        t = time.perf_counter()
        tw = tracewin.read_events(box[0].profiler.kineto_results.events())
        tw.work = done
        log(f"trace read in {time.perf_counter() - t:.1f} s")
        metrics = {}
        for m in cell.per_layer:
            v = manifest.metric_reader(cell, m["name"])(tw)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        busy = None
        if box and win.sweeps:
            t = time.perf_counter()
            busy = tracewin.device_busy_s(
                box[0].profiler.kineto_results.events())
            log(f"device activity read in {time.perf_counter() - t:.1f} s: "
                f"{busy!r} busy seconds")
        values = {"sweep_busy_s": busy / win.sweeps if busy else None,
                  "peak_mem_gib": window_peak / GIB,
                  "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end
                   if values.get(m["name"]) is not None}
    t = time.perf_counter()
    ref = reference_answers(cell, mix, tree, weights, sample, device,
                            ref_fp8.exact)
    if control:
        ctl = reference_answers(cell, mix, tree, weights, sample, device,
                                ref_fp8.fp8)
        win.answers = {k: ctl[k[1]] for k in win.answers}
    numbers, correct = check_mod.compare(win.answers, ref, cell.limits,
                                         win.bad, win.failed)
    log(f"reference: {sorted(sample)} in {time.perf_counter() - t:.1f} s, "
        f"{len(win.answers)} answers compared")
    forbidden = manifest.forbidden_modules()
    if forbidden:
        log(f"error: forbidden modules loaded: {forbidden}")
        return 5
    dev = {"platform": "gpu" if is_cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if is_cuda else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": max(setup_peak, window_peak)
           if is_cuda else 0}
    result = {"correct": bool(correct), "attempted": win.attempted,
              "failed": win.failed, "metrics": metrics, "device": dev}
    if args.trace:
        dev["busy_s"] = tw.busy_s
        dev["window_s"] = tw.window_s
        result["breakdown"] = {"device_ops": tw.device_ops,
                               "idle_gaps": tw.idle_gaps}
    result["check"] = numbers
    for name, n in numbers.items():
        log(f"check {name} {n['value']!r} limit {n['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
