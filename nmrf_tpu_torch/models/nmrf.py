"""NMRF top-level model (``nmrf_tpu/models/nmrf.py``; reference
``nmrf/models/NMRF.py:21-273``): backbone (resnet, or swin with the
deformable neck) -> group-wise cost volume -> DPN
-> NMRF inference (8x8 sub-patch decode + selection) -> refinement (4x4
sub-patch residual decode).  Channel-last throughout.  In train mode with
``aux_loss`` the output also holds every layer's predictions for the
per-layer losses.

With a spatial group (``parallel/spatial.py``) the decode region (cost
volume through disparity, :meth:`NMRF.decode`) runs on an H tile of the
features, its collectives in the modules, and so does either backbone on
an H tile of the images; ``parallel/mesh.py`` cuts the images' tiles and
reassembles the outputs.

On a card, in eval mode, without a gradient and without a spatial group,
the forward replays CUDA graphs (``models/graphs.py:Segments``): the chains
of kernels between the calls of the modules that hooks and probes watch,
which stay module calls: the model, ``backbone``, ``dpn``, ``inference``,
``refinement``, ``infer_head``, ``infer_score_head`` and every NMP
``WindowAttention`` (whose bodies and the heads' run eagerly).  Every
tensor passed to or returned from one of them is a fresh copy, never a
graph's buffer; a hook on any other module keeps the forward eager.  The
kernels and their inputs are the eager forward's, so the outputs are its
own to the bit.  The graphs are captured on the first forward at a key
(the input's shapes, the parameters' addresses and the deformable
attentions' tap radii), each inside ``nmrf::graph_capture`` within the
stage range that launches it, and kept for the 8 keys used last, until
:meth:`train`; a forward that finds them held by another call runs
eagerly, as training, the CPU, the sharded forward and an export's trace
do."""

import contextlib

import torch
from torch import nn
from torch.nn.modules import module as module_hooks
from torch.profiler import record_function

from ..ops.correlation import correlation_volume
from . import graphs
from .adaptor import MSDeformAttn, SwinAdaptor
from .backbone import Backbone
from .dpn import DPN
from .layers import ConvINReluConv, Linear, MLPBlock
from .nmp import WindowAttention
from .stages import Inference, Refinement


def _subpatch_to_full(x, patch):
    """[..., B, H, W, N, patch*patch] -> [..., B, H*patch, W*patch, N]."""
    *lead, B, H, W, N, _ = x.shape
    x = x.reshape(*lead, B, H, W, N, patch, patch)
    k = len(lead)
    perm = list(range(k)) + [k + i for i in (0, 1, 4, 2, 5, 3)]
    return x.permute(*perm).reshape(*lead, B, H * patch, W * patch, N)


def _select_argmax(values, scores):
    """values at argmax(scores) along the last axis (first maximum wins)."""
    idx = torch.argmax(scores, dim=-1, keepdim=True)
    return torch.gather(values, -1, idx).squeeze(-1)


def _lower_median_pool(x, k):
    """Block-pool [B, H, W] by k x k lower median (torch.median semantics:
    the lower of the two middle values, reference ``NMRF.py:230-231``)."""
    B, H, W = x.shape
    v = x.reshape(B, H // k, k, W // k, k).permute(0, 1, 3, 2, 4)
    v = v.reshape(B, H // k, W // k, k * k)
    return torch.sort(v, dim=-1).values[..., (k * k - 1) // 2]


class NMRF(nn.Module):
    """Neural Markov Random Field stereo model.  ``divis_by`` is the input
    divisibility the config asks for (``DATASETS.DIVIS_BY``), which
    :func:`~nmrf_tpu_torch.inference.predict` pads to."""

    def __init__(self, backbone_type="resnet", backbone_out_channels=256,
                 backbone_drop_path=0.0, msda_tap_radius=0, divis_by=8,
                 num_proposals=4,
                 max_disp=320, cost_group=4, context_dim=64,
                 prop_embed_dim=128, infer_embed_dim=128, mlp_ratio=4.0,
                 split_size=1, window_size=6, refine_window_size=4,
                 prop_n_heads=4, infer_n_heads=4, num_prop_layers=5,
                 num_infer_layers=5, num_refine_layers=5,
                 with_refinement=True, normalize_before=True,
                 gelu_approx=False, use_kernels=False, dtype=None,
                 remat=False, aux_loss=True, return_intermediate=True,
                 spatial=None):
        super().__init__()
        self.spatial = spatial
        self.aux_loss = aux_loss
        self.num_proposals = num_proposals
        self.max_disp = max_disp
        self.cost_group = cost_group
        self.with_refinement = with_refinement
        self.divis_by = divis_by
        common = dict(gelu_approx=gelu_approx, normalize_before=normalize_before,
                      use_kernels=use_kernels, dtype=dtype, remat=remat,
                      spatial=spatial)
        stage = dict(common, return_intermediate=return_intermediate)
        if backbone_type == "resnet":
            self.backbone = Backbone(backbone_out_channels, dtype=dtype,
                                     spatial=spatial)
        elif backbone_type == "swin":
            self.backbone = SwinAdaptor(
                backbone_out_channels, drop_path_rate=backbone_drop_path,
                tap_radius=msda_tap_radius, use_kernels=use_kernels,
                gelu_approx=gelu_approx, dtype=dtype, spatial=spatial)
        else:
            raise ValueError(f"unknown backbone {backbone_type!r}")
        self.concatconv = ConvINReluConv(backbone_out_channels, 128, 64,
                                         dtype=dtype, spatial=spatial)
        self.gw = ConvINReluConv(backbone_out_channels, 128, 256, dtype=dtype,
                                 spatial=spatial)
        self.dpn = DPN(cost_group, num_proposals, backbone_out_channels,
                       context_dim, num_prop_layers, prop_embed_dim,
                       mlp_ratio, split_size, prop_n_heads, **common)
        self.inference = Inference(64, 32, infer_embed_dim, num_infer_layers,
                                   mlp_ratio, window_size, infer_n_heads,
                                   **stage)
        self.infer_head = MLPBlock(infer_embed_dim, infer_embed_dim, 8 * 8, 3)
        self.infer_score_head = Linear(infer_embed_dim, 8 * 8)
        if with_refinement:
            self.refinement = Refinement(64, 32, infer_embed_dim,
                                         num_refine_layers, mlp_ratio,
                                         refine_window_size, infer_n_heads,
                                         **stage)
            self.refine_head = MLPBlock(infer_embed_dim, infer_embed_dim,
                                        4 * 4, 3)
        self.forward_graphs = graphs.GraphCache("nmrf::graph_capture")
        # the module and name of each parameter, for the graphs' key
        self._weight_slots = [(m, name) for m in self.modules()
                              for name, p in m._parameters.items()
                              if p is not None]
        # the modules whose attributes choose the kernels a graph holds,
        # which code may change in place (the train step's tap guard), for
        # the graphs' key
        self._msda = [m for m in self.modules()
                      if isinstance(m, MSDeformAttn)]
        # the modules whose calls the graphs replay: all but the watched
        # ones and the heads' eager bodies
        watched = {self, self.backbone, self.dpn, self.inference,
                   self.infer_score_head, *self.infer_head.modules(),
                   *(m for m in self.modules()
                     if isinstance(m, WindowAttention))}
        if with_refinement:
            watched.add(self.refinement)
        self._replayed = [m for m in self.modules() if m not in watched]

    def train(self, mode=True):
        """``nn.Module.train``; train mode also drops the forward's graphs,
        so that their memory goes back to training and a validation after
        a change made in training captures anew."""
        if mode:
            self.forward_graphs.clear()
        return super().train(mode)

    def forward(self, img1, img2):
        """img1/img2: [B, H, W, 3] float (0..255), H and W divisible by
        ``divis_by``.

        Returns dict: disp [B, H, W]; prob [B*H/8*W/8, D]; proposal and
        initial_proposal [B, H/8*W/8, N]; disp_pred [B, H, W] with
        refinement.  In train mode with ``aux_loss`` also
        coarse_disp_layers and logits_layers [L_i, B, H, W, N] and, with
        refinement, disp_pred_layers [L_r, B, H, W].
        """
        with self._segments(img1, img2) as replay:
            return self.decode(*self.extract_feature(img1, img2, replay),
                               replay=replay)

    @contextlib.contextmanager
    def _segments(self, img1, img2):
        """A ``with`` context that gives the forward's ``graphs.Segments``
        at this input, started, or None where the forward runs eagerly: in
        training mode, with a spatial group, off a card, with a gradient
        recorded, inside a capture or a trace, with a hook inside a graph
        (:meth:`_hooked`), or while another call holds them."""
        if self.training or self.spatial is not None \
                or not graphs.capturable(img1) or self._hooked():
            yield None
            return
        key = (img1.device,
               tuple((t.shape, t.stride(), t.dtype) for t in (img1, img2)),
               tuple(m._parameters[name].data_ptr()
                     for m, name in self._weight_slots),
               tuple((m.tap_radius, m.monitor_oob) for m in self._msda))
        with self.forward_graphs.hold(
                key, lambda: graphs.Segments("nmrf::graph_capture")) as held:
            yield None if held is None else held.start()

    def _hooked(self):
        """Whether a module whose call a graph would replay carries a hook
        or a forward of its own, or a global module hook is set: the
        forward then runs eagerly, so that each acts on every call."""
        return bool(module_hooks._global_forward_hooks
                    or module_hooks._global_forward_pre_hooks) or any(
            m._forward_hooks or m._forward_pre_hooks or "forward" in m.__dict__
            for m in self._replayed)

    def extract_feature(self, img1, img2, replay=None):
        """Both images through the backbone at once: per-image feature lists
        [1/8, 1/4] (reference ``NMRF.py:172-187``).  ``replay``: the
        forward's ``graphs.Segments`` on the graph path."""
        B = img1.shape[0]
        with record_function("nmrf::backbone"):
            feats = self.backbone(torch.cat([img1, img2], dim=0),
                                  replay=replay)[::-1]
            return [f[:B] for f in feats], [f[B:] for f in feats]

    def decode(self, f1_list, f2_list, spatial_out=False, replay=None):
        """Cost volume -> DPN -> NMP inference and refinement -> disparity
        (``nmrf.py:218-299``).  ``spatial_out`` returns prob and the
        proposals as [B, h8, w8, ...] instead of flat, so that H tiles can
        be concatenated and flattened globally.  ``replay``: the forward's
        ``graphs.Segments`` on the graph path (module docstring).

        Every op runs inside one of the profiler ranges ``nmrf::cost_volume``,
        ``nmrf::dpn``, ``nmrf::inference`` (from the 1/8 projections to the
        8x8 decode) and ``nmrf::refinement`` (from the argmax to the 4x4
        decode); ``extract_feature`` runs inside ``nmrf::backbone``.  A
        profiler trace links each backward node to its forward op by
        sequence number, so these ranges also name the backward's work."""
        B, h8, w8 = f1_list[0].shape[:3]
        with record_function("nmrf::cost_volume"):
            cost_volume = graphs.call(replay, "cost_volume",
                                      self._cost_volume, f1_list[0],
                                      f2_list[0])
        with record_function("nmrf::dpn"):
            prob, label_seeds, labels = self.dpn(cost_volume, f1_list[0],
                                                 replay=replay)
            lead = (B, h8, w8) if spatial_out else (B, -1)
            prob_out = prob.reshape(B, h8, w8, -1) if spatial_out else prob
            proposal = labels[-1].reshape(*lead, self.num_proposals)
            initial = label_seeds.reshape(*lead, self.num_proposals)

        out = {}
        with record_function("nmrf::inference"):
            fmaps = graphs.call(replay, "inference.project", self._project,
                                f1_list[0], f2_list[0])
            # the labels reach the NMP stages without gradient (the
            # proposals learn through the proposal loss only)
            labels_curr = labels[-1].reshape(B, h8, w8,
                                             self.num_proposals).detach()
            tgt = self.inference(labels_curr, *fmaps, replay=replay)
            coarse, logits = graphs.run(
                replay, "inference.decode", self._infer_decode, labels_curr,
                self.infer_head(tgt), self.infer_score_head(tgt))
            if not self.with_refinement:
                out["disp"] = graphs.call(replay, "inference.disp",
                                          _coarse_disp, coarse, logits)

        if self.with_refinement:
            with record_function("nmrf::refinement"):
                disp_curr, *fmaps = graphs.call(
                    replay, "refinement.project", self._refine_start, coarse,
                    logits, f1_list[1], f2_list[1])
                tgt_r = self.refinement(disp_curr, *fmaps, replay=replay)
                disp, disp_pred = graphs.call(
                    replay, "refinement.decode", self._refine_decode,
                    disp_curr, tgt_r)
                out["disp"] = disp
                out["disp_pred"] = disp_pred[-1]
        out["prob"] = prob_out
        out["proposal"] = proposal
        out["initial_proposal"] = initial
        if self.training and self.aux_loss:
            out["coarse_disp_layers"] = coarse
            out["logits_layers"] = logits
            if self.with_refinement:
                out["disp_pred_layers"] = disp_pred
        return out

    # the chains of kernels between the watched module calls (``decode``)

    def _cost_volume(self, f1, f2):
        return correlation_volume(f1, f2, self.max_disp // 8, self.cost_group)

    def _project(self, f1, f2):
        """The NMP stage's feature projections of both images."""
        return (self.concatconv(f1), self.concatconv(f2), self.gw(f1),
                self.gw(f2))

    def _infer_decode(self, labels, head, score):
        """Inference's 8x8 sub-patch decode -> (coarse disparities, logits),
        each [L, B, H, W, N]."""
        coarse = torch.relu(labels[None, ..., None] + head)
        logits = 0.25 * score
        return _subpatch_to_full(coarse, 8), _subpatch_to_full(logits, 8)

    def _refine_start(self, coarse, logits, f1, f2):
        """(the selected disparity, block-median pooled to 1/4 [B, H/4,
        W/4], and refinement's feature projections)."""
        disp = _select_argmax(coarse[-1], logits[-1]) * 2
        disp = _lower_median_pool(disp, 4).detach()
        return (disp, *self._project(f1, f2))

    def _refine_decode(self, disp_curr, tgt_r):
        """Refinement's 4x4 sub-patch residual decode -> (disparity [B, H,
        W], the layers' [L, B, H, W] at 1/4 scale)."""
        disp_pred = torch.relu(disp_curr[None, ..., None]
                               + self.refine_head(tgt_r))
        disp_pred = _subpatch_to_full(disp_pred[..., None, :], 4)
        disp_pred = disp_pred.squeeze(-1)  # [L, B, H, W]
        return disp_pred[-1] * 4, disp_pred


def _coarse_disp(coarse, logits):
    """The disparity without refinement: the selected candidate x 8."""
    return _select_argmax(coarse[-1], logits[-1]) * 8
