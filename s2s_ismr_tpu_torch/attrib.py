"""GradCAM and saliency by autograd (port of s2s_ismr_tpu/attrib.py).

Grad-CAM (Selvaraju et al. 2017): for a target scalar score s (the mean
predicted probability of a category over a region, summed over the batch),
weight each bottleneck channel by the spatial mean of ds/dA_k and combine:

    cam = relu( sum_k mean_hw(ds/dA_k) * A_k )

The gradient with respect to the bottleneck activations is the gradient
with respect to the U-Net's zero-valued additive tap (`bottleneck_delta`,
models/unet.py), so it runs back through the decoder only: on a CUDA
tensor, the dx mode of the conv kernel in each of the decoder's convs.
Saliency (the cnn's and mlp's attribution) takes the gradient with respect
to the input image, through every conv, the first one included.

Both run on the winner's state detached from autograd (its parameters need
no gradient, so the conv backward computes dx only, and no parameter gets
a `.grad`), with cuDNN held deterministic, in the fixed row chunks of
`engine.predict`. A map depends only on its own row, so chunking changes
nothing. `attribution` picks the method by architecture.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .models import CNN, MLP, UNet
from .train.engine import deterministic_cudnn, eval_rows


def frozen_state(model, variables, device):
    """The state to run: `variables` (a state dict; None: the model's own),
    detached and on `device`."""
    state = model.state_dict() if variables is None else variables
    return {k: v.detach().to(device) for k, v in state.items()}


def _apply(model, state, x, **kw):
    return torch.func.functional_call(model, state, (x,),
                                      {"train": False, **kw})


def _bottleneck_shape(model, x):
    """The U-Net's bottleneck activations' shape for inputs x, from its
    config (JAX runs a forward to read it)."""
    cfg = model.config
    d = 2 ** cfg.n_blocks
    return (x.shape[0], x.shape[1] // d, x.shape[2] // d, cfg.filters * 4 * d)


def _by_rows(fn, x):
    """fn over x in engine.predict's row chunks, cuDNN deterministic."""
    with deterministic_cudnn():
        return eval_rows(fn, x)


def gradcam(model, variables, x, category=2, region_mask=None,
            upsample=True):
    """Grad-CAM heatmaps for a batch of a U-Net.

    x: (N, H, W, C) inputs; category: tercile index (2 = above normal);
    region_mask: optional (H, W) bool, restricting the score to a region
    (e.g. a homogeneous climate zone); default the whole domain.
    Returns (N, H, W) heatmaps normalized to [0, 1] ((N, h, w) at the
    bottleneck's resolution without `upsample`).
    """
    x = torch.as_tensor(x, dtype=torch.float32)
    state = frozen_state(model, variables, x.device)
    w = (None if region_mask is None else
         torch.as_tensor(region_mask, dtype=torch.float32, device=x.device))

    def rows(xc):
        delta = torch.zeros(_bottleneck_shape(model, xc), device=xc.device,
                            requires_grad=True)
        inter = {}
        probs = _apply(model, state, xc, bottleneck_delta=delta,
                       intermediates=inter)
        p = probs[..., category]
        if w is not None:
            p = (p * w).sum((-2, -1)) / torch.clamp(w.sum(), min=1.0)
        else:
            p = p.mean((-2, -1))
        grads, = torch.autograd.grad(p.sum(), delta)
        acts = inter["bottleneck"].detach()
        weights = grads.mean((1, 2), keepdim=True)             # (n,1,1,K)
        cam = torch.relu((weights * acts).sum(-1))             # (n, h, w)
        cam = cam / torch.clamp(cam.amax((1, 2), keepdim=True), min=1e-12)
        if upsample:
            cam = F.interpolate(cam[:, None], size=tuple(xc.shape[1:3]),
                                mode="bilinear", align_corners=False)[:, 0]
        return cam
    return _by_rows(rows, x)


def saliency(model, variables, x, category=2):
    """Plain input-gradient saliency |d mean(p_cat) / d x|, summed over
    channels. Returns (N, H, W)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    state = frozen_state(model, variables, x.device)
    count = x.shape[0] * x.shape[1] * x.shape[2]

    def rows(xc):
        xc = xc.detach().requires_grad_()
        p = _apply(model, state, xc)[..., category]
        # the mean over all of x's rows, a chunk's part of it at a time
        g, = torch.autograd.grad(p.sum() / count, xc)
        return g.abs().sum(-1)
    return _by_rows(rows, x)


def attribution(model, variables, x, category=2):
    """GradCAM for a U-Net, saliency for the cnn and the mlp (they have no
    bottleneck tap). Returns (N, H, W)."""
    if isinstance(model, UNet):
        return gradcam(model, variables, x, category=category)
    if isinstance(model, (CNN, MLP)):
        return saliency(model, variables, x, category=category)
    raise TypeError(f"no attribution for {type(model).__name__}")
