"""NMRF processing stages: seed Propagation, Inference NMP, Refinement NMP
(``nmrf_tpu/models/stages.py``; reference ``nmrf/models/NMP.py:603-981``).

Token layout is [B, H, W, N, C] throughout.  The JAX package runs each
layer stack under ``nn.scan``; here it is a Python loop over an
``nn.ModuleList`` (torch names ``<stage>.layers.<i>.…``).  In eval mode
the stages return the last layer's normalized output with a leading axis
of 1; in train mode Inference and Refinement return every layer's
normalized output, [L, ...], for the per-layer losses (with
``return_intermediate``, as the JAX package does).  With ``remat`` each
layer runs under ``torch.utils.checkpoint`` (the JAX package's
``TPU.REMAT``): its activations are recomputed in the backward pass.  With
a spatial group (``parallel/spatial.py``) the tokens are an H tile of the
image and the group reaches the attention layers.
"""

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.encodings import fourier_coord_embed
from ..ops.sampling import disp_warp, sample_cost
from . import graphs
from .layers import GELU, LayerNorm, Linear, Mlp
from .nmp import BasicAttention, CSWinNMP, SwinNMP

ABS_ENCODING_DIM = 31  # fourier_coord_embed of one coordinate, 15 bands


def _run(layer, remat, *args):
    """One layer, rematerialized in the backward pass with ``remat``."""
    if remat and torch.is_grad_enabled():
        return checkpoint(layer, *args, use_reentrant=False)
    return layer(*args)


class PropagationLayer(nn.Module):
    """CSWin NMP with context-augmented qk (reference ``NMP.py:903-929``)."""

    def __init__(self, embed_dim, mlp_ratio, context_dim, split_size, n_heads,
                 gelu_approx=False, normalize_before=False, use_kernels=False,
                 dtype=None, spatial=None):
        super().__init__()
        self.nmp = CSWinNMP(embed_dim, embed_dim + context_dim, embed_dim,
                            n_heads, split_size=split_size, mlp_ratio=mlp_ratio,
                            gelu_approx=gelu_approx,
                            normalize_before=normalize_before,
                            use_kernels=use_kernels, dtype=dtype,
                            spatial=spatial)

    def forward(self, tgt, context):
        return self.nmp(tgt, context)


class Propagation(nn.Module):
    """Label-seed propagation (reference ``NMP.py:603-667``): embed each seed
    from its local cost profile and a Fourier disparity encoding, then run
    CSWin propagation layers conditioned on the visual context."""

    def __init__(self, embed_dim, cost_group, num_layers, mlp_ratio,
                 context_dim, split_size, n_heads, gelu_approx=False,
                 normalize_before=False, use_kernels=False, dtype=None,
                 remat=False, spatial=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.remat = remat
        self.cost_encoder = nn.Sequential(
            Linear(cost_group * 9, embed_dim, dtype=dtype),
            GELU(),  # exact erf form in the reference and the JAX package
            Linear(embed_dim, embed_dim, dtype=dtype))
        self.proj = Linear(embed_dim + ABS_ENCODING_DIM, embed_dim, bias=False,
                           dtype=dtype)
        self.dtype = dtype
        self.layers = nn.ModuleList(
            PropagationLayer(embed_dim, mlp_ratio, context_dim, split_size,
                             n_heads, gelu_approx, normalize_before,
                             use_kernels, dtype, spatial)
            for _ in range(num_layers))
        self.norm = LayerNorm(embed_dim)

    def forward(self, cost_volume, label_seed, context):
        """cost_volume: [M, G, D] (M = B*H*W); label_seed: [M, N] int;
        context: [B, H, W, C_ctx].  Returns ([1, B, H, W, N, C] f32
        embeddings, [M, N] float seeds)."""
        B, H, W, _ = context.shape
        N = label_seed.shape[-1]
        cost_feat = self.cost_encoder(sample_cost(cost_volume, label_seed))
        seeds_f = label_seed.float()
        disp_enc = fourier_coord_embed(seeds_f[..., None], 15,
                                       normalizer=3.14 / 64)
        if self.dtype is None:
            feat = torch.cat([cost_feat.float(), disp_enc], dim=-1)
        else:
            feat = torch.cat([cost_feat, disp_enc.to(self.dtype)], dim=-1)
        x = self.proj(feat).reshape(B, H, W, N, self.embed_dim)
        ctx = context[:, :, :, None, :].expand(B, H, W, N, context.shape[-1])
        for layer in self.layers:
            x = _run(layer, self.remat, x, ctx)
        return self.norm(x)[None], seeds_f


class InferenceLayer(nn.Module):
    """Self-edge attention + Swin spatial NMP (reference ``NMP.py:932-958``)."""

    def __init__(self, embed_dim, mlp_ratio, window_size, n_heads,
                 gelu_approx=False, normalize_before=False, use_kernels=False,
                 dtype=None, spatial=None):
        super().__init__()
        self.self_nmp = BasicAttention(embed_dim, ABS_ENCODING_DIM, n_heads,
                                       normalize_before, dtype=dtype)
        self.nmp = SwinNMP(embed_dim, ABS_ENCODING_DIM, n_heads, window_size,
                           mlp_ratio, gelu_approx, normalize_before,
                           candidate_mask=True, use_kernels=use_kernels,
                           dtype=dtype, spatial=spatial)

    def forward(self, tgt, abs_encoding, shift):
        return self.nmp(self._self_edges(tgt, abs_encoding), abs_encoding,
                        shift)

    def _self_edges(self, tgt, abs_encoding):
        B, H, W, N, C = tgt.shape
        x = self.self_nmp(tgt.reshape(B * H * W, N, C),
                          abs_encoding.reshape(B * H * W, N, -1))
        return x.reshape(B, H, W, N, C)

    def attn_input(self, tgt, abs_encoding):
        """(the Swin block's input, its window attention's qkv)."""
        x = self._self_edges(tgt, abs_encoding)
        return x, self.nmp.attn_input(x, abs_encoding)


class RefinementLayer(nn.Module):
    """Swin spatial NMP only, N = 1 (reference ``NMP.py:961-981``)."""

    def __init__(self, embed_dim, mlp_ratio, window_size, n_heads,
                 gelu_approx=False, normalize_before=False, use_kernels=False,
                 dtype=None, spatial=None):
        super().__init__()
        self.nmp = SwinNMP(embed_dim, ABS_ENCODING_DIM, n_heads, window_size,
                           mlp_ratio, gelu_approx, normalize_before,
                           candidate_mask=False, use_kernels=use_kernels,
                           dtype=dtype, spatial=spatial)

    def forward(self, tgt, abs_encoding, shift):
        return self.nmp(tgt, abs_encoding, shift)

    def attn_input(self, tgt, abs_encoding):
        """(the Swin block's input, its window attention's qkv)."""
        return tgt, self.nmp.attn_input(tgt, abs_encoding)


class _NMPStage(nn.Module):
    """Shared embedding, window padding and layer loop of Inference and
    Refinement (``stages.py:_NMPStage``).  In eval mode every layer's
    ``WindowAttention`` is a module call and the rest runs as the chains
    between those calls, which replay from graphs on the graph path
    (:meth:`_run_layers`)."""

    layer_cls = None

    def __init__(self, feat_dim, cost_group, dim, num_layers, mlp_ratio,
                 window_size, n_heads, gelu_approx=False,
                 normalize_before=False, use_kernels=False, dtype=None,
                 remat=False, return_intermediate=False, spatial=None):
        super().__init__()
        self.cost_group = cost_group
        self.window_size = window_size
        self.spatial = spatial
        self.remat = remat
        self.return_intermediate = return_intermediate
        self.ffn = Mlp(2 * feat_dim + cost_group, dim, dim,
                       act=GELU(gelu_approx), dtype=dtype)
        self.layers = nn.ModuleList(
            self.layer_cls(dim, mlp_ratio, window_size, n_heads, gelu_approx,
                           normalize_before, use_kernels, dtype, spatial)
            for _ in range(num_layers))
        self.norm = LayerNorm(dim)

    def _embed(self, labels, fmap1, fmap2, fmap1_gw, fmap2_gw):
        """Candidate-label embedding: warped-feature concat + group
        correlation (reference ``NMP.py:722-741``).  -> [B, H, W, N, dim]."""
        B, H, W, N = labels.shape
        G = self.cost_group
        warped_gw = disp_warp(fmap2_gw, labels)
        Cgw = fmap1_gw.shape[-1]
        f1g = fmap1_gw.reshape(B, H, W, 1, G, Cgw // G)
        wg = warped_gw.reshape(B, H, W, N, G, Cgw // G)
        corr = (f1g * wg).mean(dim=-1)
        warped = disp_warp(fmap2, labels)
        f1 = fmap1[:, :, :, None, :].expand(B, H, W, N, fmap1.shape[-1])
        feat = torch.cat([f1, warped, corr.to(f1.dtype)], dim=-1)
        return self.ffn(feat)

    def _pads(self, H, W):
        """The centered window padding (top, bottom, left, right) of an H x
        W map."""
        ws = self.window_size
        H_pad = (ws - H % ws) % ws
        W_pad = (ws - W % ws) % ws
        # an H tile must hold whole windows: padding the global H would
        # make the tiles unequal (stages.py:335-340)
        assert self.spatial is None or H_pad == 0, (
            f"spatial sharding needs the tile height {H} to be a multiple of "
            f"the window {ws}")
        return H_pad // 2, H_pad - H_pad // 2, W_pad // 2, W_pad - W_pad // 2

    def _padded(self, pads, label_rep, abs_encoding):
        tp, bp, lp, rp = pads
        if tp or bp or lp or rp:
            pad = (0, 0, 0, 0, lp, rp, tp, bp)
            label_rep = F.pad(label_rep, pad)
            abs_encoding = F.pad(abs_encoding, pad)
        return label_rep, abs_encoding

    def _cropped_norm(self, pads, x):
        """x [L, B, Hp, Wp, N, C] -> the map's own H x W, normalized."""
        tp, bp, lp, rp = pads
        return self.norm(x[:, :, tp:x.shape[2] - bp, lp:x.shape[3] - rp])

    def _shift(self, i):
        return 0 if i % 2 == 0 else self.window_size // 2

    def _run_layers(self, replay, *inputs):
        """Centered window padding of ``_tokens(*inputs)`` (label_rep,
        abs_encoding), layers with shifts 0 and ws//2 alternating, crop,
        norm.  -> [1, B, H, W, N, C] f32, or [L, B, H, W, N, C] in train
        mode with ``return_intermediate``.

        In train mode each layer is a module call (with ``remat`` a
        checkpoint of it).  In eval mode the stage runs each layer's pieces,
        its ``attn_input``, its ``WindowAttention`` call and its
        ``attn_output``, which its own forward composes: ``<stage>.0`` from
        ``inputs`` to layer 0's qkv, ``<stage>.i`` from layer i - 1's window
        attention to layer i's qkv, ``<stage>.norm`` from the last to the
        normalized output.  On the graph path (``replay``, the forward's
        ``graphs.Segments``) each of these replays from a graph, each
        window attention is called on a fresh copy of its qkv, and the
        output is a fresh tensor."""
        pads = self._pads(*inputs[0].shape[1:3])
        if self.training:
            x, abs_encoding = self._padded(pads, *self._tokens(*inputs))
            ys = []
            for i, layer in enumerate(self.layers):
                x = _run(layer, self.remat, x, abs_encoding, self._shift(i))
                if self.return_intermediate:
                    ys.append(x)
            x = torch.stack(ys) if self.return_intermediate else x[None]
            return self._cropped_norm(pads, x)

        tag = type(self).__name__.lower()

        def first(*inputs):
            x, abs_encoding = self._padded(pads, *self._tokens(*inputs))
            return (abs_encoding, *self.layers[0].attn_input(x, abs_encoding))

        def between(prev, layer):
            def chain(x, attended, abs_encoding):
                return layer.attn_input(prev.nmp.attn_output(x, attended),
                                        abs_encoding)
            return chain

        def last(prev):
            def chain(x, attended):
                return self._cropped_norm(
                    pads, prev.nmp.attn_output(x, attended)[None])
            return chain

        abs_encoding, x, qkv = graphs.run(replay, f"{tag}.0", first, *inputs)
        for i, layer in enumerate(self.layers):
            if replay is not None:
                qkv = graphs.fresh(qkv)
            attended = layer.nmp.attn(qkv, self._shift(i))
            if i + 1 < len(self.layers):
                x, qkv = graphs.run(replay, f"{tag}.{i + 1}",
                                    between(layer, self.layers[i + 1]), x,
                                    attended, abs_encoding)
        return graphs.call(replay, f"{tag}.norm", last(layer), x, attended)


class Inference(_NMPStage):
    """Neural MRF inference over candidate labels (reference
    ``NMP.py:670-798``)."""

    layer_cls = InferenceLayer

    def forward(self, labels, fmap1, fmap2, fmap1_gw, fmap2_gw, replay=None):
        """labels: [B, H, W, N] candidate disparities -> [L or 1, B, H, W,
        N, C].  ``replay``: the forward's ``graphs.Segments`` on the graph
        path."""
        return self._run_layers(replay, labels, fmap1, fmap2, fmap1_gw, fmap2_gw)

    def _tokens(self, labels, fmap1, fmap2, fmap1_gw, fmap2_gw):
        labels = labels.float()
        label_rep = self._embed(labels, fmap1, fmap2, fmap1_gw, fmap2_gw)
        abs_enc = fourier_coord_embed(labels[..., None], 15,
                                      normalizer=3.14 / 64)
        return label_rep, abs_enc


class Refinement(_NMPStage):
    """Disparity refinement at 1/4 resolution, one candidate (reference
    ``NMP.py:801-900``)."""

    layer_cls = RefinementLayer

    def forward(self, disp, fmap1, fmap2, fmap1_gw, fmap2_gw, replay=None):
        """disp: [B, H, W] -> [L or 1, B, H, W, C].  ``replay``: the
        forward's ``graphs.Segments`` on the graph path."""
        return self._run_layers(replay, disp, fmap1, fmap2, fmap1_gw,
                                fmap2_gw).squeeze(-2)

    def _tokens(self, disp, fmap1, fmap2, fmap1_gw, fmap2_gw):
        labels = disp.float()[..., None]
        label_rep = self._embed(labels, fmap1, fmap2, fmap1_gw, fmap2_gw)
        abs_enc = fourier_coord_embed(labels[..., None], 15,
                                      normalizer=3.14 / 128)
        return label_rep, abs_enc
