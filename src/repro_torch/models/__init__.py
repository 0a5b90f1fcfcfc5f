"""The LM model zoo in PyTorch: configs' data types (api), layers,
attention (GQA, MLA), the MoE FFN (moe), the decoder-LM assembly (build),
the recurrent mixers (ssm: mLSTM, sLSTM, SSD), xLSTM (xlstm), Hymba (hymba)
and ``build_model`` (zoo). The dense, MoE, SSM and hybrid families are
ported."""

from .zoo import build_model, param_count

__all__ = ["build_model", "param_count"]
