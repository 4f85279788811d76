"""Neural-backbone ASCII agent: an assigned architecture (through the
classifier head) as a Learner, fitted on the w-weighted cross-entropy per
Algorithm 2.

Counterpart of ``repro/learners/neural.py``.  Tabular features [n, p] are
projected into d_model by ``proj`` [p, d_model] and taken as a length-1
sequence, to which token 0's embedding is added; then the backbone's
layers, its final norm, the mean pool and the float32 ``cls_head``.  The
fit is ``steps`` full-batch AdamW steps, with gradients from
``torch.func.grad`` (the reference's ``jax.grad``; a leaf the loss never
reads, an untied ``lm_head``, gets zeros), so that ``torch.func.vmap``
batches it over a fleet of sessions.

The backbone is any decoder-only architecture's units (dense, MoE, SSM,
hybrid, MLA), their MoE aux loss carried and not added, as in the
reference; the encoder-decoder is refused (``classifier.check_backbone``).
It runs the einsum attention: the fit needs a backward, and the flash
kernels (``cfg.use_flash``) have none (``models/api.py`` raises for
training with them too), so a config with ``use_flash`` is refused.  Its
MoE blocks run ``moe_impl="dense"`` (the reference's default is the
grouped ``gmm``): the grouped path reads its segment lengths back to the
host, which ``torch.func.vmap`` over a fleet cannot do; the two differ in
summation order only (ROADMAP Queue 3).  The forward is float32
throughout: the params are cast up at use, which is what the reference's
promotion of its float32 features against ``cfg.dtype`` weights computes;
the gradients flow back into the params' own dtype.

The init draws its whole tree from one generator of the fit's draws
(``FitDraws.generator()``, on the CPU, then moved to the learner's
device): the classifier's params (``classifier.init_params``), then
``proj`` (he init, float32).  They are not the reference's draws; a parity
test carries the reference's init across (``convert.model_params_from_
numpy``) and starts ``NeuralCore.fit`` from it.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from repro_torch.comm.draws import fit_draws
from repro_torch.configs.base import ArchConfig
from repro_torch.learners.base import Learner, LearnerCore
from repro_torch.models import classifier, transformer
from repro_torch.models.layers import he_init
from repro_torch.optim.optimizers import adamw, tree_map


def _float32(cfg: ArchConfig) -> ArchConfig:
    """The backbone's config: float32, and the dense MoE (no host read)."""
    if cfg.use_flash:
        raise ValueError(
            f"{cfg.name}: the neural backbone's fit needs a backward, and "
            f"the flash kernels have none; set use_flash=False")
    classifier.check_backbone(cfg)
    transformer.check_supported(cfg)
    return replace(cfg, dtype="float32",
                   moe_impl="dense" if cfg.is_moe else cfg.moe_impl)


def logits(params: dict, X: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Class logits [n, K] of features X [n, p]."""
    cfg32 = _float32(cfg)
    # token 0 is the only row read: cast that row, not the whole table
    p32 = tree_map(lambda t: t.to(torch.float32),
                   {**params, "embed": {"embedding":
                                        params["embed"]["embedding"][:1]}})
    emb = (X @ p32["proj"])[:, None, :]
    tokens = torch.zeros((X.shape[0], 1), dtype=torch.long, device=X.device)
    x = emb + transformer.embed_inputs(p32, {"tokens": tokens}, cfg32)
    return classifier.pooled_logits(p32, transformer.hidden_states(
        p32, x, cfg32))


@dataclass(frozen=True)
class NeuralCore(LearnerCore):
    num_classes: int
    cfg: ArchConfig = None
    steps: int = 200
    lr: float = 1e-3
    device: str = "cuda"

    def init(self, key, shapes):
        _float32(self.cfg)
        gen = fit_draws(key).generator()
        params = classifier.init_params(self.cfg, self.num_classes, gen)
        params["proj"] = he_init(gen, (shapes[0], self.cfg.d_model),
                                 torch.float32, device=gen.device)
        return tree_map(lambda t: t.to(self.device), params)

    def fit(self, params, key, X, onehot, w):
        del key  # full-batch fit is deterministic
        opt = adamw(self.lr)
        opt_state = opt.init(params)

        def loss_fn(tree):
            out = logits(tree, X, self.cfg)
            ll = (torch.sum(onehot * out, dim=-1)
                  - torch.logsumexp(out, dim=-1))
            return -torch.sum(w * ll) / torch.clamp(torch.sum(w), min=1e-12)

        grad_fn = torch.func.grad(loss_fn)
        for i in range(self.steps):
            grads = grad_fn(params)
            with torch.no_grad():
                params, opt_state = opt.update(grads, opt_state, params, i)
        return params

    def logits(self, params, X):
        return logits(params, X, self.cfg)


@dataclass(frozen=True)
class NeuralBackbone(Learner):
    cfg: ArchConfig = None
    steps: int = 200
    lr: float = 1e-3
    device: str = "cuda"

    functional = True

    def core(self, num_classes: int) -> NeuralCore:
        return NeuralCore(num_classes, self.cfg, self.steps, self.lr,
                          self.device)

    def fit(self, key, X, classes, w, num_classes):
        core = self.core(num_classes)
        X, w = self._place(X), self._place(w)
        onehot = torch.nn.functional.one_hot(
            self._place(classes).long(), num_classes).to(torch.float32)
        return core.fit(core.init(key, tuple(X.shape[1:])), key, X, onehot,
                        w)

    def predict(self, params, X):
        return torch.argmax(logits(params, self._place(X), self.cfg), dim=-1)
