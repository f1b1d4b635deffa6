"""The reference's side of the dry-run parity tests, run in a subprocess
(importing ``repro.launch.dryrun`` forces 512 host devices on JAX, which
must not leak into the test process).  Prints one JSON object:

  python tests/_torch_dryrun_reference.py spec        # every arch x shape
                                                      # x mesh
  python tests/_torch_dryrun_reference.py hlo CELLS   # smoke cells' HLO
                                                      # FLOPs, (1, 1) mesh
  python tests/_torch_dryrun_reference.py collectives # one HLO line each
  python tests/_torch_dryrun_reference.py grad_compression

CELLS is a JSON list of [arch, kind, seq_len, global_batch].
"""
import dataclasses
import json
import os
import sys

from repro.launch import dryrun  # noqa: E402  (first: the 512 devices)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs.base import SHAPES, ShapeConfig  # noqa: E402
from repro.configs.registry import ARCH_IDS, get_config, get_smoke  # noqa
from repro.launch import hlo_analysis  # noqa: E402
from repro.launch import mesh as meshlib  # noqa: E402
from repro.models.model_zoo import build_model  # noqa: E402
from repro.sharding.rules import shard_map  # noqa: E402


def spec():
    cells = {}
    for mp in (False, True):
        mesh = meshlib.make_production_mesh(multi_pod=mp)
        for arch in ARCH_IDS:
            cfg = get_config(arch)
            model = build_model(cfg)
            plan = dryrun.PLANS[arch]
            for name, shape in SHAPES.items():
                ctx = dryrun.make_ctx(mesh, mp, shape, plan, cfg)
                cells[f"{int(mp)}|{arch}|{name}"] = dict(
                    structural_bytes=dryrun.structural_bytes(
                        cfg, shape, plan, mesh, model, ctx),
                    active_param_count=list(
                        dryrun.active_param_count(cfg, model)),
                    model_flops=dryrun.model_flops(cfg, shape, model),
                    ctx=dict(moe_impl=ctx.moe_impl, remat=ctx.remat,
                             seq_shard_kv=ctx.seq_shard_kv,
                             pod_axis=ctx.pod_axis,
                             batch_axes=ctx.batch_axes),
                    batch_pspec=list(dryrun.batch_pspec(
                        ctx, shape.global_batch, 2)))
    return dict(cells=cells,
                plans={k: dataclasses.asdict(v)
                       for k, v in dryrun.PLANS.items()},
                skips={f"{a}|{s}": r for (a, s), r in dryrun.SKIPS.items()},
                whisper_dec_len=dryrun.WHISPER_DEC_LEN)


def hlo(cells):
    mesh = meshlib.make_mesh((1, 1), ("data", "model"),
                             devices=jax.devices()[:1])
    out = {}
    for arch, kind, seq, batch in cells:
        cfg = get_smoke(arch)
        shape = ShapeConfig("smoke", seq, batch, kind)
        fn, args, _ = dryrun.build_cell(cfg, shape, mesh, False,
                                        dryrun.PLANS[arch])
        text = fn.lower(*args).compile().as_text()
        out[f"{arch}|{kind}|{seq}|{batch}"] = hlo_analysis.analyze(
            text, 1).flops
    return out


#: the collectives of the tests: (name, function of the local block, the
#: input's global shape and dtype, in/out specs); the all-to-all in fp32,
#: which XLA's CPU backend does not widen (a bf16 one it runs in fp32)
def collectives():
    mesh = meshlib.make_mesh((2, 4), ("pod", "data"),
                             devices=jax.devices()[:8])
    cases = {
        "psum": (lambda x: jax.lax.psum(x, "pod"), (8, 96), jnp.float32,
                 P("data", None), P("data", None)),
        "all_gather": (lambda x: jax.lax.all_gather(x, "data", axis=0,
                                                    tiled=True),
                       (64, 24), jnp.int8, P("data", None), P(None, None)),
        "psum_scatter": (lambda x: jax.lax.psum_scatter(
            x, "data", scatter_dimension=0, tiled=True), (32, 40),
            jnp.float32, P(None, None), P("data", None)),
        "all_to_all": (lambda x: jax.lax.all_to_all(x, "data", 0, 0),
                       (4, 6, 16), jnp.float32, P(None, None, None),
                       P(None, None, None)),
    }
    out = {}
    for name, (f, shape, dt, ins, outs) in cases.items():
        fn = shard_map(f, mesh=mesh, in_specs=ins, out_specs=outs,
                       check_vma=False)
        text = jax.jit(fn).lower(
            jax.ShapeDtypeStruct(shape, dt)).compile().as_text()
        c = hlo_analysis.analyze(text, 8)
        out[name] = dict(collective_bytes=c.collective_bytes,
                         details=[list(d[1:]) for d in
                                  c.collective_details])
    return out


def grad_compression():
    """The reference example's two figures, by running its ``main``."""
    import contextlib
    import io
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "examples"))
    import grad_compression as ex
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ex.main()
    out = {}
    for line in buf.getvalue().splitlines():
        name, _, rest = line.partition(":")
        out[name] = float(rest.rsplit("=", 1)[1].replace(",", ""))
    return out


if __name__ == "__main__":
    what = sys.argv[1]
    if what == "spec":
        res = spec()
    elif what == "hlo":
        res = hlo(json.loads(sys.argv[2]))
    elif what == "collectives":
        res = collectives()
    else:
        res = grad_compression()
    print(json.dumps(res))
