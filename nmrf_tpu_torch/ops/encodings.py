"""Fourier positional / coordinate encodings (``nmrf_tpu/ops/encodings.py``;
reference ``nmrf/models/NMP.py:11-51``)."""

import math

import torch


def fourier_coord_embed(coord, n_freqs, normalizer=3.14 / 512, logscale=True):
    """[..., D] coordinates -> [..., D*(2*n_freqs+1)], per coordinate
    [sin(f1 x)..sin(fN x), cos(f1 x)..cos(fN x), x] with x = coord *
    normalizer (the literal 3.14-based normalizers of the reference)."""
    kw = dict(dtype=coord.dtype, device=coord.device)
    if logscale:
        freq_bands = 2.0 ** torch.linspace(0.0, n_freqs - 1, n_freqs, **kw)
    else:
        freq_bands = torch.linspace(1.0, 2.0 ** (n_freqs - 1), n_freqs, **kw)
    scaled = coord[..., None] * normalizer
    f = scaled * freq_bands
    embed = torch.cat([torch.sin(f), torch.cos(f), scaled], dim=-1)
    return embed.reshape(*coord.shape[:-1], coord.shape[-1] * (2 * n_freqs + 1))


def fourier_grid_embed(shape, embed_dim, dtype=torch.float32, device=None):
    """[*shape, embed_dim] sin/cos grid embedding of a spatial shape."""
    n_axes = len(shape)
    assert embed_dim % (2 * n_axes) == 0, (embed_dim, shape)
    num_bands = embed_dim // (2 * n_axes)
    kw = dict(dtype=dtype, device=device)
    axis_pos = [torch.linspace(-1.0, 1.0, s, **kw) for s in shape]
    pos = torch.stack(torch.meshgrid(*axis_pos, indexing="ij"), dim=-1)
    freq_bands = torch.linspace(1.0, num_bands, num_bands, **kw)
    emb = pos[..., None] * freq_bands * math.pi
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    return emb.reshape(*shape, embed_dim)
