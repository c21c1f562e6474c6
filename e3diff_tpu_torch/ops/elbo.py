"""ELBO loss of the sequence D3PM (counterpart of e3diff_tpu/ops/elbo.py;
elbo_loss, sequence_model/utils.py:132-161).

Quirk Q11 is kept exactly: the "target" is a one-hot that is softmaxed,
the NLL term is the entropy of the prediction, and the KL follows torch's
kl_div(log_p, q, 'batchmean'): sum(q (log q - log p)) / N over rows. The
mask selects rows, as the reference's boolean index does.
"""

from __future__ import annotations

import torch


def elbo_loss(logits_pred, logits_target, mask=None, eps: float = 1e-6):
    """NLL (the prediction's entropy) + KL(softmax(target) ||
    softmax(pred)). logits: (..., K); mask: the leading dims, or None."""
    probs1 = torch.softmax(logits_pred, dim=-1)
    probs2 = torch.softmax(logits_target, dim=-1)
    log_probs1 = torch.log_softmax(logits_pred + eps, dim=-1)
    log_probs2 = torch.log(probs2)
    kl_row = (probs2 * (log_probs2 - log_probs1)).sum(-1)
    nll_row = -(probs1 * log_probs1).sum(-1)
    if mask is None:
        return kl_row.sum() / kl_row.numel() + nll_row.mean()
    m = mask.to(kl_row.dtype)
    n = torch.clamp(m.sum(), min=1.0)
    return (kl_row * m).sum() / n + (nll_row * m).sum() / n
