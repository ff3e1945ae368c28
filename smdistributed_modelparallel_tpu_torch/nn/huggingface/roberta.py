"""HF RoBERTa translation.

A copy of ``smdistributed_modelparallel_tpu/nn/huggingface/roberta.py``.

Parity target: reference ``torch/nn/huggingface/roberta.py`` (the reference
distributes ``RobertaEncoder`` only; here, as with BERT, the whole
``RobertaModel`` body maps onto ``DistributedTransformerLMHead``).

RoBERTa is architecturally BERT with one embedding quirk: position ids are
pad-aware (HF ``create_position_ids_from_input_ids`` — real tokens count
from ``padding_idx + 1`` skipping pads), and the position table carries
``max_position_embeddings`` (= 514 for the 512-token model) rows — carried
here by ``position_ids_from_padding``. Token-type table has a single row.

State-dict convention: translators accept either bare ``RobertaModel``
keys or ``roberta.``-prefixed ones, and EMIT bare body keys (the
registered architecture's layout).
"""

from smdistributed_modelparallel_tpu_torch.nn.huggingface import bert
from smdistributed_modelparallel_tpu_torch.nn.huggingface import common as c  # noqa: F401

HF_ARCHITECTURES = ("RobertaModel", "RobertaForMaskedLM", "RobertaForCausalLM")


def config_to_smp(config):
    """HF RobertaConfig -> DistributedTransformerLMHead kwargs."""
    out = bert.config_to_smp(config)
    # Pad-aware positions (HF create_position_ids_from_input_ids): real
    # tokens skip pads, pad tokens sit at the pad position.
    out["position_ids_from_padding"] = config.pad_token_id
    return out


def _reprefix(fn):
    def wrapped(sd, config=None):
        # BERT translator keys on the "bert." body prefix; RoBERTa's body
        # prefix is "roberta." (bare RobertaModel state dicts have none).
        sd = {
            (("bert." + k[len("roberta."):]) if k.startswith("roberta.") else k): v
            for k, v in sd.items()
        }
        return fn(sd, config=config)

    return wrapped


translate_hf_state_dict = _reprefix(bert.translate_hf_state_dict)


# bert's to-HF emitter already produces bare body keys, which is also the
# RobertaModel layout.
translate_state_dict_to_hf = bert.translate_state_dict_to_hf
