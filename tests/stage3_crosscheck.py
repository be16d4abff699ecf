"""Stage 3 of scripts/bench_rich_scene.sh under the JAX package, over a
stage-1 field the port trained (on the card), on the CPU.  A tool run by
hand, not a test: a run takes about 30 minutes at the script's batch.

    JAX_PLATFORMS=cpu python tests/stage3_crosscheck.py <port stage-1
        workspace> <scene> <out dir> [--replay] [CLI flags]

The port's newest checkpoint in the workspace becomes JAX parameters
(the inverse of models/convert.py's rules), and the JAX CLI trains and
evaluates stage 3 with the bench script's stage-3 flags, then the given
flags (`--seed N`, or a smaller batch: `--num_rays 512
--online_resolution 128 --error_map_size 32`), and prints its MeanIoU.

--replay also records the JAX run's batches, its initial parameters and
the error map at steps 150, 151 and 200, then runs the port's CLI on the
CPU over the same field with the JAX run's mask-branch init and its
batches in place of the port's sampler, and prints each logged step's CE
and accuracy and the error maps beside JAX's.  The ray-pair term draws
its anchors at random, so pass `--ray_pair_rgb_loss_weight 0` with it.
"""
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import flax  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import sanerf_hq_tpu.cli as jcli  # noqa: E402
import sanerf_hq_tpu.train.stages as jstages  # noqa: E402
from sanerf_hq_tpu.models import make_field  # noqa: E402
from sanerf_hq_tpu_torch import cli  # noqa: E402
from sanerf_hq_tpu_torch.models.convert import (_RULES, flatten,  # noqa: E402
                                                params_from_jax)
from sanerf_hq_tpu_torch.train import stages  # noqa: E402
from sanerf_hq_tpu_torch.train import trainer as T  # noqa: E402
from sanerf_hq_tpu_torch.train.checkpoints import CheckpointManager  # noqa: E402

STAGE3 = ["--data_type", "llff", "--contract", "--bound", "128",
          "--min_near", "0.05", "--field_type", "mlp", "--with_mask",
          "--n_inst", "2", "--iters", "200", "--num_rays", "6000",
          "--ray_pair_rgb_loss_weight", "1", "--ray_pair_rgb_threshold",
          "0.1", "--ray_pair_rgb_iter", "150", "--ray_pair_rgb_num_sample",
          "8", "--local_sample_patch_size", "8", "--num_local_sample", "4",
          "--mixed_sampling", "--error_map", "--eval_cnt", "1",
          "--save_cnt", "1"]
MAP_STEPS = (150, 151, 200)


def jax_params(model_sd, cfg):
    """The port's stage-1 state_dict as the JAX MLP field's parameter
    tree."""
    model = make_field("mlp", grid_bound=cfg.grid_bound, cp_rank=cfg.cp_rank,
                       cp_res=cfg.cp_res, density_bias=cfg.density_bias)
    tree = flax.core.unfreeze(
        model.init(jax.random.PRNGKey(0), jnp.zeros((4, 3)),
                   jnp.ones((4, 3))))
    nested = {}
    for key, v in flatten(tree).items():
        path = key[len("params/"):]
        for pattern, template, transpose in _RULES:
            m = pattern.fullmatch(path)
            if m:
                arr = model_sd[m.expand(template)].numpy()
                arr = arr.T if transpose else arr
                assert arr.shape == tuple(v.shape), (key, arr.shape)
                break
        else:
            raise KeyError(key)
        d = nested
        for p in key.split("/")[:-1]:
            d = d.setdefault(p, {})
        d[key.split("/")[-1]] = jnp.asarray(arr)
    return nested


def run_jax(argv, model_sd, record=None):
    """The JAX CLI on argv with the port's field as its init checkpoint;
    record: a dict that receives the run's batches, initial parameters,
    metrics and error maps."""
    cfg = jcli.config_from_args(jcli.build_parser().parse_args(argv))
    tree = jax_params(model_sd, cfg)
    jcli.load_init_params = lambda path: tree
    if record is not None:
        make = jstages.make_mask_train_step

        def patched(*a, **k):
            step = make(*a, **k)

            def wrapped(state, batch, key, error_map):
                if record["init"] is None:
                    record["init"] = jax.device_get(state.params)
                record["batches"].append(
                    {n: np.asarray(v) for n, v in batch.items()})
                if len(record["batches"]) in MAP_STEPS:
                    record["maps"][len(record["batches"])] = np.asarray(
                        error_map)
                state, m, em = step(state, batch, key, error_map)
                record["metrics"].append({n: float(v) for n, v in m.items()})
                return state, m, em
            return wrapped
        jstages.make_mask_train_step = patched
    jcli.main(argv)


def replay(argv, record):
    """The port's CLI on argv (CPU) with the JAX run's mask-branch init and
    batches; prints the logged steps and the error maps beside JAX's."""
    init = params_from_jax(record["init"])
    mask_keys = [k for k in init if k.startswith(("cp_m_", "mask_mlp"))]
    make_trainer = T.Trainer.__init__

    def init_hook(self, *a, **k):
        make_trainer(self, *a, **k)
        with torch.no_grad():
            params = dict(self.model.named_parameters())
            for n in mask_keys:
                params[n].copy_(init[n])
            for n, v in init.items():  # the backbone is JAX's, bit for bit
                assert n in mask_keys or torch.equal(params[n], v), n

    batches, maps = iter(record["batches"]), {}

    def sample(*a, **k):
        maps[len(maps) + 1] = a[4].clone()  # the error map it draws from
        b = next(batches)
        out = {n: torch.as_tensor(b[n]) for n in ("rays_o", "rays_d",
                                                   "local_error")}
        out.update({n: torch.as_tensor(b[n]).long()
                    for n in ("gt_masks", "img_inds", "inds_coarse")})
        return out

    T.Trainer.__init__ = init_hook
    stages.sample_mask_batch = sample
    t = cli.main(argv + ["--device", "cpu"])
    for s, v in t.stats["mask"]:
        j = record["metrics"][s - 1]
        print(f"[replay] step {s}: port ce {v['ce']:.6f} acc {v['acc']:.4f}; "
              f"jax ce {j['ce']:.6f} acc {j['acc']:.4f}", flush=True)
    for s in MAP_STEPS:
        j, p = record["maps"][s], maps[s].numpy()
        d = np.abs(j - p)
        print(f"[replay] error map at step {s}: max abs diff {d.max():.3e}, "
              f"mean {d.mean():.3e}; cells above 0.5: jax {(j > 0.5).sum()}, "
              f"port {(p > 0.5).sum()}", flush=True)


def main(args):
    ws, scene, out = args[:3]
    flags = [a for a in args[3:] if a != "--replay"]
    model_sd = torch.load(CheckpointManager(ws).latest_path(),
                          map_location="cpu", weights_only=True)["model"]
    common = [scene, *STAGE3, "--mask_root", os.path.join(scene, "masks"),
              "--init_ckpt", ws]
    record = ({"batches": [], "metrics": [], "maps": {}, "init": None}
              if "--replay" in args else None)
    run_jax(common + ["--workspace", os.path.join(out, "jax")] + flags,
            model_sd, record)
    if record is not None:
        replay(common + ["--workspace", os.path.join(out, "port")] + flags,
               record)


if __name__ == "__main__":
    main(sys.argv[1:])
