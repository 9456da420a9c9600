"""SAM-Med2D-style promptable 2D segmentation (the JAX package's
``models/sam.py``), channels-last.

- ``ImageEncoderViT``: a patch-embed conv and a pre-LN transformer encoder
  with learned positional embeddings, then a 2-conv neck (LayerNorm between)
  to the prompt embedding width;
- ``PromptEncoder``: points (fg/bg), boxes (a corner pair) and dense mask
  prompts; sparse prompts are random-Fourier positional encodings plus
  learned type embeddings, dense prompts a small conv stack, else a learned
  no-mask embedding;
- ``MaskDecoder``: a two-way transformer (token→image and image→token
  cross attention), a 4× transposed-conv upscaling, per-mask hypernetwork
  MLPs and an IoU head; 1 + ``num_multimask_outputs`` candidate masks;
- ``SAMMed2D``: the three; ``model(image, point_coords, point_labels,
  boxes, mask_inputs, multimask_output)`` → (low-res mask logits (B, M, h,
  w), IoU predictions (B, M)).  ``sam_loss`` is the SAM recipe's
  focal + dice + IoU-MSE objective.

Prompts are fixed-width tensors with SAM's validity convention (label -1 is
padding: ``point_embeddings[4]`` and a zeroed positional encoding).  The
flax defaults are kept: LayerNorm epsilon 1e-6, the tanh GELU, flax's
'SAME' padding (the 3×3 neck conv pads 1; the 2×2 stride-2 convs of the
mask prompt, on its even sizes, pad nothing).  Attention is plain PyTorch
(``F.scaled_dot_product_attention``); the JAX package runs it in XLA, no
Pallas kernel.

Each module keeps its flax parameter names as attribute names
(``q_proj``, ``LayerNorm_0``, ``ConvTranspose_1``, ``hyper2_l0``,
``mask_downscale.layers_3``, ``pos_embed``, ...), so a ``state_dict`` key
is the flax path joined with dots; ``utils/param_bridge.py``
(``sam_flax_to_state_dict`` / ``sam_state_dict_to_flax``) converts the
layouts.  ``save_sam`` / ``load_sam`` read and write the JAX package's
bundle (``config.json`` + ``params.msgpack``).  Parameters are float32.
"""

from __future__ import annotations

import json
import math
import os
from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.initializers import lecun_normal
from ..utils import flax_msgpack
from .wrappers import _checked_device

_LN_EPS = 1e-6  # flax nn.LayerNorm's default


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # flax nn.gelu's default


def _layer_norm(d: int, device=None) -> nn.LayerNorm:
    return nn.LayerNorm(d, eps=_LN_EPS, device=device)


class _Conv(nn.Module):
    """A channels-last 2D conv with a torch-layout ``weight`` (O, I, kh, kw),
    stride and symmetric padding explicit."""

    def __init__(self, cin: int, cout: int, k: int, *, stride: int = 1,
                 padding: int = 0, bias: bool = True, device=None):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k,
                                               device=device))
        self.bias = (nn.Parameter(torch.empty(cout, device=device))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight, self.bias,
                     stride=self.stride, padding=self.padding)
        return y.permute(0, 2, 3, 1)


class _ConvTranspose2x2(nn.Module):
    """flax ``ConvTranspose(features, (2, 2), strides=(2, 2))`` on NHWC: the
    output is exactly twice the input; the torch ``weight`` is (I, O, 2, 2)
    with the taps of the flax kernel flipped (the bridge flips them)."""

    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cin, cout, 2, 2, device=device))
        self.bias = nn.Parameter(torch.empty(cout, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), self.weight, self.bias,
                               stride=2)
        return y.permute(0, 2, 3, 1)


class MLPBlock(nn.Module):
    def __init__(self, dim: int, mlp_dim: int, device=None):
        super().__init__()
        self.Dense_0 = nn.Linear(dim, mlp_dim, device=device)
        self.Dense_1 = nn.Linear(mlp_dim, dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(_gelu(self.Dense_0(x)))


class Attention(nn.Module):
    """Multi-head attention with q/k/v projected to ``dim //
    downsample_rate`` and projected back to ``dim``."""

    def __init__(self, dim: int, num_heads: int, downsample_rate: int = 1,
                 device=None):
        super().__init__()
        inner = dim // downsample_rate
        self.num_heads = num_heads
        self.q_proj = nn.Linear(dim, inner, device=device)
        self.k_proj = nn.Linear(dim, inner, device=device)
        self.v_proj = nn.Linear(dim, inner, device=device)
        self.out_proj = nn.Linear(inner, dim, device=device)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        return x.reshape(b, n, self.num_heads, c // self.num_heads
                         ).transpose(1, 2)

    def forward(self, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
        out = F.scaled_dot_product_attention(
            self._heads(self.q_proj(q)), self._heads(self.k_proj(k)),
            self._heads(self.v_proj(v)))
        b, h, n, hd = out.shape
        return self.out_proj(out.transpose(1, 2).reshape(b, n, h * hd))


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 device=None):
        super().__init__()
        self.LayerNorm_0 = _layer_norm(dim, device)
        self.Attention_0 = Attention(dim, num_heads, device=device)
        self.LayerNorm_1 = _layer_norm(dim, device)
        self.MLPBlock_0 = MLPBlock(dim, int(dim * mlp_ratio), device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, N, D)
        h = self.LayerNorm_0(x)
        x = x + self.Attention_0(h, h, h)
        return x + self.MLPBlock_0(self.LayerNorm_1(x))


class ImageEncoderViT(nn.Module):
    def __init__(self, img_size: int = 256, patch_size: int = 16,
                 in_chans: int = 1, embed_dim: int = 384, depth: int = 6,
                 num_heads: int = 6, out_chans: int = 256, device=None):
        super().__init__()
        self.depth = depth
        grid = img_size // patch_size
        self.patch_embed = _Conv(in_chans, embed_dim, patch_size,
                                 stride=patch_size, device=device)
        self.pos_embed = nn.Parameter(
            torch.empty(1, grid, grid, embed_dim, device=device))
        for i in range(depth):
            setattr(self, f"block{i}",
                    TransformerBlock(embed_dim, num_heads, device=device))
        self.LayerNorm_0 = _layer_norm(embed_dim, device)
        # the neck: 1x1 then 3x3, LayerNorm between (SAM's LN2d)
        self.Conv_0 = _Conv(embed_dim, out_chans, 1, bias=False,
                            device=device)
        self.LayerNorm_1 = _layer_norm(out_chans, device)
        self.Conv_1 = _Conv(out_chans, out_chans, 3, padding=1, bias=False,
                            device=device)
        self.LayerNorm_2 = _layer_norm(out_chans, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(x) + self.pos_embed  # (B, h, w, D)
        b, h, w, d = x.shape
        x = x.reshape(b, h * w, d)
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
        x = self.LayerNorm_0(x).reshape(b, h, w, d)
        x = self.LayerNorm_1(self.Conv_0(x))
        return self.LayerNorm_2(self.Conv_1(x))


class _MaskDownscale(nn.Module):
    """flax's ``nn.Sequential`` of the dense prompt: conv 2x2/2, LN, GELU,
    conv 2x2/2, LN, GELU, conv 1x1 (params under ``layers_k``)."""

    def __init__(self, mask_in_chans: int, embed_dim: int, device=None):
        super().__init__()
        c4 = mask_in_chans // 4
        self.layers_0 = _Conv(1, c4, 2, stride=2, device=device)
        self.layers_1 = _layer_norm(c4, device)
        self.layers_3 = _Conv(c4, mask_in_chans, 2, stride=2, device=device)
        self.layers_4 = _layer_norm(mask_in_chans, device)
        self.layers_6 = _Conv(mask_in_chans, embed_dim, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _gelu(self.layers_1(self.layers_0(x)))
        x = _gelu(self.layers_4(self.layers_3(x)))
        return self.layers_6(x)


class PromptEncoder(nn.Module):
    def __init__(self, embed_dim: int = 256,
                 image_embedding_size: Tuple[int, int] = (16, 16),
                 input_image_size: Tuple[int, int] = (256, 256),
                 mask_in_chans: int = 16, device=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.image_embedding_size = tuple(image_embedding_size)
        self.input_image_size = tuple(input_image_size)
        self.pe_gaussian = nn.Parameter(
            torch.empty(2, embed_dim // 2, device=device))
        # 0: bg point, 1: fg point, 2: box corner A, 3: box corner B, 4: pad
        self.point_embeddings = nn.Parameter(
            torch.empty(5, embed_dim, device=device))
        self.no_mask_embed = nn.Parameter(
            torch.empty(1, embed_dim, device=device))
        self.mask_downscale = _MaskDownscale(mask_in_chans, embed_dim,
                                             device=device)

    def _pe_encode(self, coords: torch.Tensor) -> torch.Tensor:
        """Random-Fourier positional encoding of [0,1]² coords."""
        proj = 2.0 * math.pi * ((2.0 * coords - 1.0) @ self.pe_gaussian)
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)

    def dense_pe(self) -> torch.Tensor:
        """Positional encoding of the image-embedding grid (h, w, D)."""
        h, w = self.image_embedding_size
        dev = self.pe_gaussian.device
        ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        grid = torch.stack(torch.meshgrid(xs, ys, indexing="xy"), dim=-1)
        return self._pe_encode(grid)

    def forward(self, point_coords: Optional[torch.Tensor],
                point_labels: Optional[torch.Tensor],
                boxes: Optional[torch.Tensor] = None,
                mask_inputs: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """points (B, P, 2) in input pixels with labels (B, P) (1 fg, 0 bg,
        -1 pad); boxes (B, 2, 2) corner pixels; mask_inputs (B, 4h, 4w, 1).
        → sparse (B, P [+ 2], D), dense (B, h, w, D) embeddings."""
        sparse = []
        ih, iw = self.input_image_size
        size = torch.tensor([iw, ih], dtype=torch.float32,
                            device=self.pe_gaussian.device)
        pe_table = self.point_embeddings
        if point_coords is not None:
            pe = self._pe_encode(point_coords / size)  # (B, P, D)
            lab = point_labels[..., None]
            emb = torch.where(lab == 1, pe_table[1],
                              torch.where(lab == 0, pe_table[0], pe_table[4]))
            pe = torch.where(lab == -1, torch.zeros_like(pe), pe)
            sparse.append(pe + emb)
        if boxes is not None:
            pe = self._pe_encode(boxes / size)  # (B, 2, D)
            sparse.append(pe + pe_table[2:4])
        if not sparse:
            raise ValueError("at least one of points/boxes must be provided")
        sparse_embeddings = torch.cat(sparse, dim=1)
        if mask_inputs is not None:
            dense = self.mask_downscale(mask_inputs)
        else:
            h, w = self.image_embedding_size
            dense = self.no_mask_embed.reshape(1, 1, 1, -1).expand(
                sparse_embeddings.shape[0], h, w, self.embed_dim)
        return sparse_embeddings, dense


class TwoWayBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_dim: int = 2048,
                 skip_first_layer_pe: bool = False, device=None):
        super().__init__()
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = Attention(dim, num_heads, device=device)
        self.LayerNorm_0 = _layer_norm(dim, device)
        self.cross_attn_t2i = Attention(dim, num_heads, 2, device=device)
        self.LayerNorm_1 = _layer_norm(dim, device)
        self.MLPBlock_0 = MLPBlock(dim, mlp_dim, device=device)
        self.LayerNorm_2 = _layer_norm(dim, device)
        self.cross_attn_i2t = Attention(dim, num_heads, 2, device=device)
        self.LayerNorm_3 = _layer_norm(dim, device)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.LayerNorm_0(queries)
        # tokens -> image
        q, k = queries + query_pe, keys + key_pe
        queries = self.LayerNorm_1(queries + self.cross_attn_t2i(q, k, keys))
        queries = self.LayerNorm_2(queries + self.MLPBlock_0(queries))
        # image -> tokens
        q = queries + query_pe
        keys = self.LayerNorm_3(keys + self.cross_attn_i2t(k, q, queries))
        return queries, keys


class MaskDecoder(nn.Module):
    def __init__(self, transformer_dim: int = 256, depth: int = 2,
                 num_heads: int = 8, num_multimask_outputs: int = 3,
                 iou_head_depth: int = 3, device=None):
        super().__init__()
        d = transformer_dim
        self.depth = depth
        self.n_mask_tokens = num_multimask_outputs + 1
        self.iou_head_depth = iou_head_depth
        self.iou_token = nn.Parameter(torch.empty(1, d, device=device))
        self.mask_tokens = nn.Parameter(
            torch.empty(self.n_mask_tokens, d, device=device))
        for i in range(depth):
            setattr(self, f"block{i}", TwoWayBlock(
                d, num_heads, skip_first_layer_pe=(i == 0), device=device))
        self.final_attn = Attention(d, num_heads, 2, device=device)
        self.LayerNorm_0 = _layer_norm(d, device)
        self.ConvTranspose_0 = _ConvTranspose2x2(d, d // 4, device=device)
        self.LayerNorm_1 = _layer_norm(d // 4, device)
        self.ConvTranspose_1 = _ConvTranspose2x2(d // 4, d // 8,
                                                 device=device)
        for i in range(self.n_mask_tokens):
            for j in range(2):
                setattr(self, f"hyper{i}_l{j}", nn.Linear(d, d, device=device))
            setattr(self, f"hyper{i}_out", nn.Linear(d, d // 8, device=device))
        for j in range(iou_head_depth - 1):
            setattr(self, f"iou_l{j}", nn.Linear(d, d, device=device))
        self.iou_out = nn.Linear(d, self.n_mask_tokens, device=device)

    def forward(self, image_embeddings, image_pe, sparse_prompts,
                dense_prompts) -> Tuple[torch.Tensor, torch.Tensor]:
        b, h, w, d = image_embeddings.shape
        m = self.n_mask_tokens
        output_tokens = torch.cat([self.iou_token, self.mask_tokens], dim=0)
        tokens = torch.cat([output_tokens[None].expand(b, -1, -1),
                            sparse_prompts], dim=1)
        src = (image_embeddings + dense_prompts).reshape(b, h * w, d)
        pos = image_pe.reshape(1, h * w, d).expand(b, h * w, d)

        queries, keys = tokens, src
        for i in range(self.depth):
            queries, keys = getattr(self, f"block{i}")(queries, keys, tokens,
                                                       pos)
        # the final token->image attention
        q, k = queries + tokens, keys + pos
        queries = self.LayerNorm_0(queries + self.final_attn(q, k, keys))
        iou_out = queries[:, 0]
        mask_out = queries[:, 1:1 + m]

        # upscale the image features 4x
        src = keys.reshape(b, h, w, d)
        src = _gelu(self.LayerNorm_1(self.ConvTranspose_0(src)))
        src = _gelu(self.ConvTranspose_1(src))  # (B, 4h, 4w, d/8)

        hyper = []
        for i in range(m):
            t = mask_out[:, i]
            for j in range(2):
                t = F.relu(getattr(self, f"hyper{i}_l{j}")(t))
            hyper.append(getattr(self, f"hyper{i}_out")(t))
        hyper = torch.stack(hyper, dim=1)  # (B, M, d/8)
        masks = torch.einsum("bmc,bhwc->bmhw", hyper, src)

        t = iou_out
        for j in range(self.iou_head_depth - 1):
            t = F.relu(getattr(self, f"iou_l{j}")(t))
        return masks, self.iou_out(t)


_CONFIG_KEYS = ("img_size", "in_channels", "embed_dim", "encoder_depth",
                "encoder_heads", "prompt_embed_dim", "decoder_depth",
                "num_multimask_outputs")


class SAMMed2D(nn.Module):
    """Promptable 2D segmentation: ViT encoder + prompt encoder + two-way
    mask decoder, with the JAX package's defaults.  Built on the CPU with
    its initializers drawn from ``generator`` (a fresh one seeded 0 when
    none is given; flax's defaults: lecun-normal kernels, zero biases, unit
    LayerNorms, N(0, 0.02²) positional embeddings, N(0, 1) prompt tables
    and tokens), then moved to ``device``: the card by default, the CPU when
    asked, ``"meta"`` for the structure alone.  Starts in eval mode.
    ``multimask_output`` selects the 3 candidate masks instead of the
    primary one."""

    def __init__(self, img_size: int = 256, in_channels: int = 1,
                 embed_dim: int = 384, encoder_depth: int = 6,
                 encoder_heads: int = 6, prompt_embed_dim: int = 256,
                 decoder_depth: int = 2, num_multimask_outputs: int = 3, *,
                 device: Union[str, torch.device] = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = _checked_device(device)
        build_on = device if device.type == "meta" else torch.device("cpu")
        self.img_size = img_size
        self.in_channels = in_channels
        self.embed_dim = embed_dim
        self.encoder_depth = encoder_depth
        self.encoder_heads = encoder_heads
        self.prompt_embed_dim = prompt_embed_dim
        self.decoder_depth = decoder_depth
        self.num_multimask_outputs = num_multimask_outputs
        grid = img_size // 16
        self.image_encoder = ImageEncoderViT(
            img_size=img_size, in_chans=in_channels, embed_dim=embed_dim,
            depth=encoder_depth, num_heads=encoder_heads,
            out_chans=prompt_embed_dim, device=build_on)
        self.prompt_encoder = PromptEncoder(
            embed_dim=prompt_embed_dim, image_embedding_size=(grid, grid),
            input_image_size=(img_size, img_size), device=build_on)
        self.mask_decoder = MaskDecoder(
            transformer_dim=prompt_embed_dim, depth=decoder_depth,
            num_multimask_outputs=num_multimask_outputs, device=build_on)
        if device.type != "meta":
            self.reset_parameters(generator
                                  or torch.Generator().manual_seed(0))
            self.to(device)
        self.eval()

    def config(self) -> dict:
        return {k: getattr(self, k) for k in _CONFIG_KEYS}

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initializers, drawn in registration order."""
        normal_1 = ("pe_gaussian", "point_embeddings", "no_mask_embed",
                    "iou_token", "mask_tokens")
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            owner = self.get_submodule(name.rsplit(".", 1)[0])
            if leaf == "pos_embed":
                p.normal_(0.0, 0.02, generator=generator)
            elif leaf in normal_1:
                p.normal_(0.0, 1.0, generator=generator)
            elif isinstance(owner, nn.LayerNorm):
                p.fill_(1.0 if leaf == "weight" else 0.0)
            elif leaf == "bias":
                p.zero_()
            elif isinstance(owner, _ConvTranspose2x2):
                # (I, O, 2, 2): fan_in is the flax kernel's kh·kw·I
                lecun_normal(p.view(-1, p.numel() // p.shape[1]), generator)
            else:  # Linear (O, I), conv (O, I, kh, kw)
                lecun_normal(p.view(p.shape[0], -1), generator)

    def forward(self, image: torch.Tensor,
                point_coords: Optional[torch.Tensor] = None,
                point_labels: Optional[torch.Tensor] = None,
                boxes: Optional[torch.Tensor] = None,
                mask_inputs: Optional[torch.Tensor] = None,
                multimask_output: bool = False,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        img_emb = self.image_encoder(image)
        sparse, dense = self.prompt_encoder(point_coords, point_labels,
                                            boxes, mask_inputs)
        masks, iou_pred = self.mask_decoder(
            img_emb, self.prompt_encoder.dense_pe(), sparse, dense)
        if multimask_output:
            return masks[:, 1:], iou_pred[:, 1:]
        return masks[:, :1], iou_pred[:, :1]


def sam_loss(mask_logits: torch.Tensor, iou_pred: torch.Tensor,
             target: torch.Tensor, *, focal_alpha: float = 0.25,
             focal_gamma: float = 2.0, focal_weight: float = 20.0
             ) -> torch.Tensor:
    """SAM training objective: 20·focal + dice + IoU-MSE (per the paper).
    ``mask_logits`` (B, 1, h, w) low-res logits, ``iou_pred`` (B, 1),
    ``target`` (B, H, W) binary, resized bilinearly to (h, w) and
    thresholded at 0.5 when its size differs."""
    from ..ops.image import resize_bilinear

    b, m, h, w = mask_logits.shape
    logits = mask_logits[:, 0]
    if tuple(target.shape[1:]) != (h, w):
        t = resize_bilinear(target[..., None].float(), (h, w))[..., 0]
        t = (t > 0.5).float()
    else:
        t = target.float()

    p = torch.sigmoid(logits)
    ce = -(t * F.logsigmoid(logits) + (1 - t) * F.logsigmoid(-logits))
    p_t = p * t + (1 - p) * (1 - t)
    alpha_t = focal_alpha * t + (1 - focal_alpha) * (1 - t)
    focal = (alpha_t * (1 - p_t) ** focal_gamma * ce).mean()
    inter = (p * t).sum(dim=(1, 2))
    dice = 1 - (2 * inter + 1.0) / (p.sum(dim=(1, 2)) + t.sum(dim=(1, 2))
                                    + 1.0)
    dice = dice.mean()
    pred_mask = (p > 0.5).float()
    gt_iou = ((pred_mask * t).sum(dim=(1, 2)) + 1e-6) / (
        torch.maximum(pred_mask, t).sum(dim=(1, 2)) + 1e-6)
    iou_mse = torch.square(iou_pred[:, 0] - gt_iou.detach()).mean()
    return focal_weight * focal + dice + iou_mse


# ---------------------------------------------------------------------------
# persistence (serving / checkpointing)
# ---------------------------------------------------------------------------


def save_sam(path: str, model: SAMMed2D) -> None:
    """Write a SAM bundle (config.json + params.msgpack), loadable by the
    JAX package's ``load_sam``."""
    from ..utils.param_bridge import sam_state_dict_to_flax

    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(model.config(), f, indent=2)
    flax_msgpack.save(os.path.join(path, "params.msgpack"),
                      sam_state_dict_to_flax(model.state_dict()))


def load_sam(path: str, *,
             device: Union[str, torch.device] = "cuda") -> SAMMed2D:
    """Restore a SAM bundle saved by either package's ``save_sam`` onto
    ``device`` (the card by default; ``"cpu"`` when asked)."""
    from ..utils.param_bridge import sam_flax_to_state_dict

    with open(os.path.join(path, "config.json")) as f:
        config = json.load(f)
    model = SAMMed2D(**config, device="meta")
    sd = sam_flax_to_state_dict(
        flax_msgpack.load(os.path.join(path, "params.msgpack")))
    model.load_state_dict(sd, strict=True, assign=True)
    return model.to(device=_checked_device(device),
                    dtype=torch.float32).eval()
