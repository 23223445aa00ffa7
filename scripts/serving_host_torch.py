"""Standalone serving host for tpu_ac_torch artifacts: NO tpu_ac_torch import.

Everything a serving process needs is the artifact (``torch.export``
programs, the source of the module that registers the min_dists ops, the
kernel's source and library, and the meta), a params file, and stock torch
and numpy.  The model code and the package are not required.

    # produce the inputs (on the card, with tpu_ac_torch):
    python -m tpu_ac_torch.cli.export --n_images 32 \\
        --output serving.tpuac --dump_params params.npy

    # serve (this script; another machine or environment is fine):
    python scripts/serving_host_torch.py serving.tpuac --params params.npy \\
        --images category_images.npy        # [N,3,H,W] uint8
    python scripts/serving_host_torch.py serving.tpuac --params params.npy \\
        --bench                             # synthetic-image throughput

Outputs alpha ([N, P] per-image patch weights) and X ([N, D] weighted
embeddings), the arrays stage 2 (clustering + metrics) consumes.  The ops'
module is loaded from the artifact under a private name and pointed at the
artifact's kernel library, so the alpha program's min_dists node launches
the hand-written kernel on the card.  TF32 is allowed around the embed
program's calls as ``meta["precision"]`` says and off around the alpha+X
programs, as the live path scopes it.  Params are uploaded once, the
train bank embedded once, and Z stays on the device.  Sharded
(``--dp``) artifacts are served over ``meta["n_devices"]`` positions
(``--devices``; ``cuda:0 cuda:0`` runs a 2-rank mesh on one card, its
ranks one after another).  Each time reported stands beside the card's
name and power limit.
"""

import argparse
import contextlib
import importlib.util
import io
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# tpu_ac_torch/utils/export.py FORMAT_VERSION
FORMAT_VERSION = "tpu_ac_torch/1"
OPS_MODULE = "_serving_min_dists_ops"


def check_no_package() -> None:
    loaded = sorted(m for m in sys.modules if m.startswith("tpu_ac"))
    if loaded:
        raise RuntimeError(f"the serving host imported {loaded}")


@contextlib.contextmanager
def tf32_scope(allow: bool):
    """The TF32 switches of cuBLAS matmuls and cuDNN convs for the duration
    of some program calls, restored on exit.  They are global state and no
    part of a graph, so the host sets them as the live path does
    (``tpu_ac_torch.device.precision_scope``): allowed around the embed
    unless ``meta["precision"]`` is "highest", and off around the alpha+X
    programs, which the live path runs in full f32."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def card_line(device: torch.device) -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", str(device.index or 0)],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def load_ops(blob, device: torch.device, workdir: str):
    """Register the artifact's min_dists ops (its copy of
    tpu_ac_torch/kernels/distances.py, under a private name) and, for a
    CUDA device, point them at the kernel library."""
    spec = importlib.util.spec_from_loader(OPS_MODULE, loader=None)
    ops = importlib.util.module_from_spec(spec)
    sys.modules[OPS_MODULE] = ops
    exec(compile(blob["ops_source"], "<artifact: kernels/distances.py>",
                 "exec"), ops.__dict__)
    if device.type == "cuda":  # a cuda export always carries its library
        so = os.path.join(workdir, "libmin_dists.so")
        with open(so, "wb") as f:
            f.write(blob["kernel_library"])
        ops.LIBRARY_PATH = so
    return ops


def load_programs(path, device: torch.device, workdir: str):
    """(programs {name: ExportedProgram}, meta, ops module) of the
    artifact's ``device`` platform."""
    with open(path, "rb") as f:
        blob = pickle.load(f)
    if blob.get("format_version") != FORMAT_VERSION:
        raise SystemExit(
            f"unsupported export format {blob.get('format_version')!r}: "
            f"this host serves {FORMAT_VERSION!r} artifacts")
    if device.type not in blob["programs"]:
        raise SystemExit(f"the artifact holds programs for "
                         f"{sorted(blob['programs'])}, not {device.type}")
    ops = load_ops(blob, device, workdir)
    progs = {name: torch.export.load(io.BytesIO(data))
             for name, data in blob["programs"][device.type].items()}
    return progs, blob["meta"], ops


class Programs:
    """The artifact's programs, each callable on a given device: a program
    traced on cuda:0 is moved (its constants and the devices its graph
    names) for another card of a mesh."""

    def __init__(self, progs):
        self._eps = progs
        self._cache = {}

    def on(self, name: str, device: torch.device):
        key = (name, device)
        if key not in self._cache:
            ep = self._eps[name]
            if device.type == "cuda" and (device.index or 0) != 0:
                from torch.export.passes import move_to_device_pass

                ep = move_to_device_pass(ep, {"cuda:0": str(device)})
            self._cache[key] = ep.module()
        return self._cache[key]


def upload_params(raw: dict, dtype: torch.dtype, devices) -> dict:
    """{device: params} for each distinct device, uploaded once.  A
    bfloat16 array of ml_dtypes (tpu_ac's bfloat16 dump) is read through
    its bits."""
    host = {}
    for k, v in raw.items():
        t = torch.from_numpy(v.view(np.uint16)).view(torch.bfloat16) \
            if v.dtype.name == "bfloat16" else torch.from_numpy(v)
        host[k] = t.to(dtype)
    return {d: {k: v.to(d) for k, v in host.items()}
            for d in dict.fromkeys(devices)}


def embed_all(progs, meta, params, images, devices):
    """Embed [N,3,H,W] uint8 in the artifact's fixed batch size (the tail
    batch padded), each batch split into one shard per device, with TF32
    as ``meta["precision"]`` says; the result [N, P, D] stays on the first
    device."""
    n = images.shape[0]
    batch_size = meta["batch_size"]
    home = devices[0]
    out = []
    with tf32_scope(meta["precision"] != "highest"):
        for i in range(0, n, batch_size):
            chunk = images[i:i + batch_size]
            if chunk.shape[0] < batch_size:
                pad = np.zeros((batch_size - chunk.shape[0],
                                *chunk.shape[1:]), chunk.dtype)
                chunk = np.concatenate([chunk, pad])
            host = torch.from_numpy(chunk)
            for shard, d in zip(host.chunk(len(devices)), devices):
                z = progs.on("embed", d)(params[d], shard.to(d))
                out.append(z.to(home))
    return torch.cat(out)[:n]


def embed_to_capacity(progs, meta, params, images, capacity, devices):
    """Embed a [N,3,H,W] uint8 image set and zero-pad the rows to the
    artifact ``capacity`` (on the first device)."""
    z = embed_all(progs, meta, params, images, devices)
    return torch.cat([z, z.new_zeros(capacity - z.shape[0], *z.shape[1:])])


def _count(n: int) -> torch.Tensor:
    return torch.tensor(n, dtype=torch.int64)


def _sharded_alpha_x(progs, meta, z_pad, n, devices, zt_pad, n_train):
    """The rank programs on their devices, then the combine on the
    first."""
    kind = meta["rank_kind"]
    n_local = z_pad.shape[0] // len(devices)
    banks = {d: (zt_pad if kind == "min" else z_pad).to(d)
             for d in dict.fromkeys(devices)}
    parts = []
    for r, d in enumerate(devices):
        z_local = z_pad[r * n_local:(r + 1) * n_local].to(d)
        counts = ((_count(n_train),) if kind == "min" else
                  (_count(r * n_local), _count(n)) if kind == "triangle"
                  else (_count(n),))
        parts.append(progs.on("rank", d)(z_local, banks[d], *counts))
    counts = (_count(n),) if kind == "triangle" else ()
    return progs.on("combine", devices[0])(parts, z_pad, *counts)


def alpha_x(progs, meta, z_pad, n, devices, zt_pad=None, n_train=None):
    """The packed alpha+X [N_pad, P+D] of an embedded, padded category on
    the first device, TF32 off (the live path's full f32)."""
    with tf32_scope(False):
        if meta.get("sharded"):
            return _sharded_alpha_x(progs, meta, z_pad, n, devices, zt_pad,
                                    n_train)
        if meta["supervised"] == "supervised":
            return progs.on("alpha_x", devices[0])(
                z_pad, zt_pad, _count(n), _count(n_train))
        return progs.on("alpha_x", devices[0])(z_pad, _count(n))


def serve_category(progs, meta, params, images, devices, zt_pad=None,
                   n_train=None):
    """(alpha [N, P], X [N, D]) numpy of one category.  ``params`` come
    from ``upload_params`` (once, at start-up).  Supervised artifacts
    weight patches by distance to a TRAIN (nominal) bank: pass ``zt_pad``
    / ``n_train``, the train split embedded once by
    :func:`embed_to_capacity`."""
    n = images.shape[0]
    cap = meta["n_images_capacity"]
    if n > cap:
        raise SystemExit(f"category size {n} exceeds artifact capacity "
                         f"{cap}; re-export with a larger --n_images")
    supervised = meta["supervised"] == "supervised"
    if supervised and zt_pad is None:
        raise SystemExit("supervised artifact: pass the embedded train "
                         "bank (zt_pad/n_train — see embed_to_capacity)")
    with torch.inference_mode():
        z_pad = embed_to_capacity(progs, meta, params, images, cap, devices)
        packed = alpha_x(progs, meta, z_pad, n, devices, zt_pad, n_train)
        packed = packed[:n].cpu().numpy()
    p = meta["n_patches"]  # packed rows are [alpha (P patch weights), X (D)]
    return packed[:, :p], packed[:, p:]


def _devices(a, meta) -> list:
    n_dev = meta.get("n_devices", 1)
    if a.devices:
        devices = [torch.device(d) for d in a.devices]
    elif a.device == "cuda":
        devices = [torch.device(f"cuda:{i}") for i in range(n_dev)]
    else:
        devices = [torch.device(a.device)] * n_dev
    if len(devices) != n_dev:
        raise SystemExit(f"the artifact runs on {n_dev} positions; got "
                         f"--devices {a.devices}")
    types = {d.type for d in devices}
    if len(types) != 1:
        raise SystemExit(f"--devices mixes {sorted(types)}")
    if "cuda" in types:
        if not torch.cuda.is_available():
            raise SystemExit("CUDA is not available: pass --device cpu")
        missing = [d for d in devices
                   if (d.index or 0) >= torch.cuda.device_count()]
        if missing:
            raise SystemExit(
                f"{missing} not on this machine ({torch.cuda.device_count()} "
                f"cards); a {n_dev}-rank mesh on one card: --devices "
                + " ".join(["cuda:0"] * n_dev))
    return devices


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="serve a tpu_ac_torch artifact without tpu_ac_torch")
    ap.add_argument("artifact")
    ap.add_argument("--params", required=True,
                    help=".npy (allow_pickle) dict of backbone params")
    ap.add_argument("--images", default=None,
                    help=".npy [N,3,H,W] uint8 category images")
    ap.add_argument("--train_images", default=None,
                    help=".npy [N,3,H,W] uint8 nominal/train split "
                         "(required for supervised artifacts)")
    ap.add_argument("--out", default=None,
                    help="write alpha/X to this .npz")
    ap.add_argument("--bench", action="store_true",
                    help="time 5 more calls on the same images")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="platform to serve on (cpu must be asked for)")
    ap.add_argument("--devices", nargs="+", default=None,
                    help="the mesh positions of a sharded artifact, e.g. "
                         "cuda:0 cuda:1 (default: the first n_devices "
                         "cards)")
    a = ap.parse_args(argv)
    check_no_package()

    with tempfile.TemporaryDirectory() as workdir:
        platform = torch.device(
            a.devices[0] if a.devices else a.device).type
        eps, meta, ops = load_programs(a.artifact, torch.device(platform),
                                       workdir)
        devices = _devices(a, meta)
        card = card_line(devices[0])
        progs = Programs(eps)
        dtype = getattr(torch, meta["param_dtype"])
        raw = np.load(a.params, allow_pickle=True).item()
        params = upload_params(raw, dtype, devices)
        print(f"artifact: platforms={meta['platforms']} "
              f"batch={meta['batch_size']} "
              f"capacity={meta['n_images_capacity']} "
              f"mode={meta['supervised']} tau={meta['tau']} "
              f"precision={meta['precision']} devices="
              f"{[str(d) for d in devices]}; card: {card}", flush=True)

        train_images = None
        if a.train_images:
            train_images = np.load(a.train_images)
        elif meta["supervised"] == "supervised":
            if a.images:
                # real images + a made-up train bank would produce garbage
                # alpha/X with exit code 0: refuse instead
                raise SystemExit("supervised artifact: --train_images is "
                                 "required when serving real --images (the "
                                 "synthetic train bank is only for "
                                 "--bench/synthetic runs)")
            rng = np.random.default_rng(1)
            train_images = rng.integers(
                0, 255, (meta["batch_size"], 3, meta["imagesize"],
                         meta["imagesize"]), dtype=np.uint8)
            print(f"(no --train_images: using {train_images.shape[0]} "
                  "synthetic train images)", flush=True)
        if a.images:
            images = np.load(a.images)
        else:
            rng = np.random.default_rng(0)
            images = rng.integers(
                0, 255, (meta["n_images_capacity"], 3, meta["imagesize"],
                         meta["imagesize"]), dtype=np.uint8)
            print(f"(no --images: using {images.shape[0]} synthetic "
                  "images)", flush=True)

        # the train bank is fixed across categories: embed it ONCE
        zt_pad, n_train = None, None
        if train_images is not None:
            t_cap = meta["n_train_capacity"]
            if train_images.shape[0] > t_cap:
                raise SystemExit(
                    f"train split {train_images.shape[0]} exceeds artifact "
                    f"train capacity {t_cap}; re-export with a larger "
                    "--n_train_images")
            with torch.inference_mode():
                zt_pad = embed_to_capacity(progs, meta, params, train_images,
                                           t_cap, devices)
            n_train = train_images.shape[0]

        ops.LAUNCHES = ops.WINDOW_LAUNCHES = ops.PLAIN_CALLS = 0
        t0 = time.perf_counter()
        alpha, x = serve_category(progs, meta, params, images, devices,
                                  zt_pad, n_train)
        first_s = time.perf_counter() - t0
        calls = 1
        print(f"category served: alpha {alpha.shape} X {x.shape} in "
              f"{first_s:.3f} s (first call) on {card}", flush=True)
        result = {"n_images": int(images.shape[0]), "first_s": first_s,
                  "card": card}
        if a.bench:
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                serve_category(progs, meta, params, images, devices, zt_pad,
                               n_train)
                times.append(time.perf_counter() - t0)
            calls += 5
            med = sorted(times)[len(times) // 2]
            result.update(serve_s=times, median_s=med,
                          images_per_s=images.shape[0] / med)
            print(f"serving throughput: {images.shape[0] / med:.1f} "
                  f"images/sec (median of 5, N={images.shape[0]}, "
                  f"{med:.3f} s a category) on {card}", flush=True)
        result.update(categories=calls, launches=ops.LAUNCHES,
                      window_launches=ops.WINDOW_LAUNCHES,
                      plain_calls=ops.PLAIN_CALLS)
        check_no_package()
        print(json.dumps({"serving": result}), flush=True)

        if a.out:
            np.savez(a.out, alpha=alpha, X=x)
            print("wrote", a.out)


if __name__ == "__main__":
    main()
