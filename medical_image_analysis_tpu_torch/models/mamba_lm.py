"""The Mamba language model of EMRRG's text finetune, with its decode step.

Counterpart of ``medical_image_analysis_tpu/models/mamba_lm.py``, with its
parameter names: ``embed_tokens``, ``depth`` one-direction
``MambaBlock``s ``layers_<i>`` (RMSNorm, eps 1e-5, fp32 residual),
``norm_f`` (flax LayerNorm, eps 1e-6), and logits tied to the embedding
(``x @ embed_tokens.weight.T``, flax's ``attend``). The blocks' mixers
run the fused kernels (``scan_backend="auto"``) as the JAX package does
on its accelerator.

``peft_cfg`` (a :class:`..peft.mamba_peft.MambaPEFTConfig`) turns on the
activation-space adapters: an AdaptFormer bottleneck beside each block
(``adaptf_down_<i>``, ``adaptf_up_<i>``, the latter zero at init), prompt
tuning (``prompt_encoder`` (1, P, d_model) before the tokens) and prefix
tuning (``prefix_encoder`` (depth, 1, V, d_model): V virtual tokens put
before each block's input and stripped after it). LoRA on the X half of
``in_proj`` applies through ``peft.lora.mamba_partial_x_rules``; the
weight-space family merges through ``peft.mamba_peft`` (a model built at
``effective_d_state`` runs the merged parameters, ``step`` included).

``init_states`` and ``step`` decode one token at a time through the
blocks' conv and SSM states, in plain PyTorch (the adapters play no part
there, as in the JAX package).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.mesh import loss_denominator
from .common import layer_norm
from .mamba import MambaBlock

D_CONV = 4  # the mixer's default taps


class _ZeroLinear(nn.Linear):
    """A Linear whose kernel and bias start at 0 (``adaptf_up``)."""

    @torch.no_grad()
    def init_own_params(self, gen: torch.Generator):
        self.weight.zero_()
        self.bias.zero_()


class MambaLM(nn.Module):
    def __init__(self, vocab_size: int, d_model: int = 768, depth: int = 12,
                 d_state: int = 16, expand: int = 2, rms_norm: bool = True,
                 scan_backend: str = "auto", peft_cfg=None, device=None):
        super().__init__()
        self.d_model, self.depth, self.d_state = d_model, depth, d_state
        self.d_inner = expand * d_model
        self.peft_cfg = pc = peft_cfg
        self.embed_tokens = nn.Embedding(vocab_size, d_model, device=device)
        self.layers = nn.ModuleList(
            MambaBlock(d_model, d_state=d_state, expand=expand,
                       bimamba_type="none", rms_norm=rms_norm,
                       scan_backend=scan_backend, device=device)
            for _ in range(depth))
        self.norm_f = layer_norm(d_model, device=device)
        if pc is not None and pc.adaptformer:
            for i in range(depth):
                self.add_module(f"adaptf_down_{i}", nn.Linear(
                    d_model, pc.dim_adaptf, device=device))
                self.add_module(f"adaptf_up_{i}", _ZeroLinear(
                    pc.dim_adaptf, d_model, device=device))
        if pc is not None and pc.prompt_tuning:
            self.prompt_encoder = nn.Parameter(torch.empty(
                1, pc.prompt_num_tokens, d_model, device=device))
        if pc is not None and pc.prefix_tuning:
            self.prefix_encoder = nn.Parameter(torch.empty(
                depth, 1, pc.num_virtual_tokens, d_model, device=device))

    @torch.no_grad()
    def init_own_params(self, gen: torch.Generator):
        for name in ("prompt_encoder", "prefix_encoder"):
            p = getattr(self, name, None)
            if p is not None:
                tmp = torch.empty(p.shape, device=p.device)
                p.copy_(tmp.normal_(0.0, 0.02, generator=gen))

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """The final norm and the tied output projection."""
        return self.norm_f(x) @ self.embed_tokens.weight.T

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """(B, L) token ids -> logits (B, L, V)."""
        pc = self.peft_cfg
        x = self.embed_tokens(input_ids.long())
        b = x.shape[0]
        prompt = pc is not None and pc.prompt_tuning
        prefix = pc is not None and pc.prefix_tuning
        if prompt:
            x = torch.cat([self.prompt_encoder.expand(b, -1, -1), x], dim=1)
        for i, blk in enumerate(self.layers):
            if prefix:
                x = torch.cat([self.prefix_encoder[i].expand(b, -1, -1), x],
                              dim=1)
            y = blk(x)
            if pc is not None and pc.adaptformer:
                down = getattr(self, f"adaptf_down_{i}")
                up = getattr(self, f"adaptf_up_{i}")
                y = y + pc.s_adaptf * up(F.relu(down(x)))
            x = y
            if prefix:
                x = x[:, pc.num_virtual_tokens:]
        if prompt:
            x = x[:, pc.prompt_num_tokens:]
        return self.logits(x)

    def init_states(self, batch: int) -> list:
        """Each block's zero (conv (B, 3, d_inner), ssm (B, d_inner, N))
        states, fp32, on the model's device."""
        dev = self.embed_tokens.weight.device
        return [(torch.zeros(batch, D_CONV - 1, self.d_inner, device=dev),
                 torch.zeros(batch, self.d_inner, self.d_state, device=dev))
                for _ in range(self.depth)]

    def step(self, token: torch.Tensor, states: list):
        """One decode step: token (B,) -> (logits (B, V), new states)."""
        x = self.embed_tokens(token.long())
        new_states = []
        for blk, (conv_s, ssm_s) in zip(self.layers, states):
            x, conv_s, ssm_s = blk.step(x, conv_s, ssm_s)
            new_states.append((conv_s, ssm_s))
        return self.logits(x), new_states


def lm_loss(logits: torch.Tensor, input_ids: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    """Next-token cross-entropy over the positions that ``mask`` keeps."""
    lp = torch.log_softmax(logits[:, :-1], dim=-1)
    ll = torch.gather(lp, -1, input_ids[:, 1:, None].long())[..., 0]
    m = mask[:, 1:].float()
    return -torch.sum(ll * m) / loss_denominator(torch.sum(m), 1.0)


def alpaca_prompt(instruction: str, inp: str = "", response: str = "") -> str:
    """Alpaca-style prompt, byte for byte the JAX package's."""
    if inp:
        return (
            "below is an instruction that describes a task , paired with an "
            "input . write a response .\n### instruction : "
            f"{instruction}\n### input : {inp}\n### response : {response}"
        )
    return (
        "below is an instruction that describes a task . write a response "
        f".\n### instruction : {instruction}\n### response : {response}"
    )
