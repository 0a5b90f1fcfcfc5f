"""The LM model zoo in PyTorch: configs' data types (api), layers,
attention (GQA, MLA), the MoE FFN (moe), the decoder-LM assembly (build),
the recurrent mixers (ssm: mLSTM, sLSTM, SSD), xLSTM (xlstm), Hymba (hymba),
Whisper (whisper), the decoder LM's tensor- and expert-parallel hooks on a
mesh's shards (sharded) and
``build_model`` (zoo). Every family of the JAX package is ported: dense,
MoE, vlm, audio, SSM and hybrid."""

from .zoo import build_model, param_count

__all__ = ["build_model", "param_count"]
