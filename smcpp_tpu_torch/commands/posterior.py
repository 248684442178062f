"""smc++ posterior: decode the posterior TMRCA distribution along contigs.

Port of smcpp_tpu/commands/posterior.py for one and two populations, on
``--device``.  Under a process group the decode shards over the ranks: by
default each rank loads only its own contiguous shard of the files and
writes its rows to ``<output>.procI.npz`` (I its rank; the heatmap, too);
with ``--replicated-data`` every rank loads every file and rank 0 writes
``<output>``."""

import json
import logging
import os
import sys

import numpy as np

from .. import trace
from ..data import format as fmt
from ..inference import estimation
from ..inference.manager import make_manager
from ..models import model_from_dict
from ..parallel import distributed, hostlocal
from . import command

logger = logging.getLogger(__name__)


def posterior_quantiles(gamma, hidden_states, qs):
    """Posterior TMRCA quantiles per row from the decoded state masses.

    Piecewise-linear CDF inversion within each hidden interval; the
    terminal (infinite) interval reports its left edge.  Returns
    (len(qs), L) in coalescent units."""
    with trace.span("posterior.quantiles"):
        cdf = np.cumsum(gamma, axis=0)  # (M, L)
        hs = np.asarray(hidden_states)
        out = np.empty((len(qs), gamma.shape[1]))
        for qi, q in enumerate(qs):
            m = np.argmax(cdf >= q, axis=0)  # first interval crossing q
            prev = np.take_along_axis(
                np.vstack([np.zeros((1, cdf.shape[1])), cdf]), m[None], 0
            )[0]
            g = np.take_along_axis(gamma, m[None], 0)[0]
            lo, hi = hs[m], hs[m + 1]
            hi = np.where(np.isinf(hi), lo, hi)
            frac = np.clip((q - prev) / np.maximum(g, 1e-30), 0.0, 1.0)
            out[qi] = lo + frac * (hi - lo)
        return out


class Posterior(command.Command, command.ConsoleCommand):
    "Store/visualize posterior decoding of TMRCA"

    def __init__(self, parser):
        command.Command.__init__(self, parser)
        command.add_hmm_args(parser)
        parser.add_argument("--start", type=int, help="first base to decode")
        parser.add_argument("--end", type=int, help="last base to decode")
        parser.add_argument("--thinning", type=int, default=1, metavar="k",
                            help="emit full SFS only every k-th site")
        parser.add_argument("--heatmap", metavar="heatmap.(pdf|png|jpeg)",
                            help="draw a heatmap of the posterior TMRCA")
        parser.add_argument("--colorbar", action="store_true")
        parser.add_argument("--M", type=int, default=32,
                            help="number of hidden states")
        parser.add_argument("--map", action="store_true", dest="map_path",
                            help="also store the MAP (Viterbi) state path "
                                 "per contig as '<path>_map'")
        parser.add_argument("--intervals", type=lambda s: [
                                float(x) for x in s.split(",")
                            ], default=None, metavar="q1,q2,...",
                            help="store posterior TMRCA quantiles (e.g. "
                                 "0.025,0.5,0.975) per row as "
                                 "'<path>_quantiles' (coalescent units)")
        parser.add_argument("--profile-dir", default=None,
                            help="write a torch.profiler Chrome trace of the "
                                 "decode here (trace.json)")
        parser.add_argument("model", metavar="model.final.json")
        parser.add_argument("output", metavar="arrays.npz")
        parser.add_argument("data", nargs="+", metavar="data.smc[.gz]")

    def main(self, args):
        """Decode and write the npz; returns the inference manager."""
        command.Command.main(self, args)
        if args.colorbar and not args.heatmap:
            sys.exit("Can't specify --colorbar without --heatmap")
        return command.run_profiled(lambda: self._decode(args), args)

    def _decode(self, args):
        "Load, decode and write the npz; returns the inference manager."
        with open(args.model) as f:
            j = json.load(f)
        m = model_from_dict(j["model"])
        files = fmt.files_from_command_line_args(args.data)
        data_keys = list(args.data)
        mesh = distributed.current()
        local_data = hostlocal.active(mesh) and not args.replicated_data
        out_path, hdr = args.output, None
        if local_data:
            all_files = files
            headers, files = hostlocal.shard_ingestion(all_files, mesh)
            if len({(p, tuple(n), tuple(a)) for p, n, a in headers}) > 1:
                sys.exit("All data sets must share population / sample size")
            hdr = headers[0]
            data_keys = files  # npz keys: the expanded file paths
            base, ext = os.path.splitext(args.output)
            # the .npz extension last (np.savez appends it otherwise)
            out_path = f"{base}.proc{mesh.rank}{ext or '.npz'}"
            logger.info(
                "host-local posterior: process %d/%d decodes %d of %d files "
                "-> %s", mesh.rank, mesh.size, len(files), len(all_files),
                out_path,
            )
        contigs = fmt.load_data(files)
        if not local_data and len({c.key for c in contigs}) > 1:
            sys.exit("All data sets must share population / sample size")
        hidden_states = estimation.balance_hidden_states(
            m.distinguished_model, args.M + 1
        )
        all_obs = []
        for contig in contigs:
            obs = contig.data
            npop = obs.shape[1] // 3
            lb = 0 if args.start is None else args.start
            ub = obs[:, 0].sum() if args.end is None else args.end
            pos = np.cumsum(obs[:, 0])
            obs = obs[(pos >= lb) & (pos <= ub)]
            obs = np.insert(obs, 0, [[1] + [-1, 0, 0] * npop], 0)
            all_obs.append(obs)
        if args.thinning > 1:
            from ..data.filters import thin_data

            all_obs = [thin_data(o, args.thinning) for o in all_obs]
        if hdr is not None:
            # the population structure from the headers: a rank's shard may
            # be empty, yet every rank builds the same manager
            pid, n, a = hdr
        else:
            pid, n, a = contigs[0].pid, contigs[0].n, contigs[0].a
        im = make_manager(n, a, all_obs, hidden_states, tuple(pid),
                          args.polarization_error, device=args.device,
                          precision=args.precision, local_data=local_data)
        im.set_model(m)
        im.theta = j["theta"]
        im.rho = j["rho"]
        if "alpha" not in j:
            # old-schema model JSONs predate the alpha field
            logger.warning("model JSON has no 'alpha' field; assuming 1")
        im.alpha = j.get("alpha", 1)
        im.save_gamma = True
        im.E_step()
        gammas = []
        with trace.span("posterior.normalise"):
            for i, g in enumerate(im.gammas):
                # drop padding rows and normalize columns, matching the
                # reference's (M, L) layout (posterior.py:95-105)
                Lr = len(all_obs[i])
                g = g[:Lr].T
                colsum = g.sum(axis=0)
                colsum[colsum == 0] = 1.0
                gammas.append(g / colsum)
        kwargs = {path: g for path, g in zip(data_keys, gammas)}
        kwargs.update(
            {path + "_sites": o[:, 0] for path, o in zip(data_keys, all_obs)}
        )
        if args.map_path:
            for path, p in zip(data_keys, im.map_paths()):
                kwargs[path + "_map"] = p[: len(kwargs[path + "_sites"])]
        if args.intervals:
            for path, g in zip(data_keys, gammas):
                kwargs[path + "_quantiles"] = posterior_quantiles(
                    g, hidden_states, args.intervals
                )
        if not local_data and mesh is not None and mesh.rank != 0:
            return im  # replicated: rank 0 writes what every rank holds
        with trace.span("posterior.save"):
            np.savez_compressed(out_path, hidden_states=hidden_states, **kwargs)
        if args.heatmap and gammas:
            if local_data:
                base, ext = os.path.splitext(args.heatmap)
                args.heatmap = f"{base}.proc{mesh.rank}{ext}"
            self._heatmap(args, all_obs[0], gammas[0], hidden_states)
        return im

    def _heatmap(self, args, obs, gamma, hidden_states):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from matplotlib.image import NonUniformImage

        fig, ax = plt.subplots()
        x = np.insert(np.cumsum(obs[:, 0]), 0, 0)
        y = hidden_states[:-1]
        img = NonUniformImage(
            ax, interpolation="bilinear", extent=(0, x.max(), y[0], y[-1])
        )
        img.set_data(x[: gamma.shape[1]], y, gamma)
        ax.add_image(img)
        ax.set_xlim((0, x.max()))
        ax.set_ylim((y[0], y[-1]))
        ax.set_xlabel("Position (bp)")
        ax.set_ylabel("TMRCA")
        if args.colorbar:
            plt.colorbar(img)
        plt.savefig(args.heatmap)
        plt.close()
