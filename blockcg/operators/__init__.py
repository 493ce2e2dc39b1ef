from blockcg.operators.base import LinearOperator, MatmatMixin
from blockcg.operators.csr import CSROperator, ELLOperator
from blockcg.operators.dia import DIAOperator
from blockcg.operators.bsr import BSROperator
from blockcg.operators.bdia import BlockDIAOperator
from blockcg.operators.cbdia import ConstBlockDIAOperator
from blockcg.operators.tiled import TiledOperator
from blockcg.operators.dense import DenseOperator
from blockcg.operators.realify import RealifiedHermitianOperator, realify
from blockcg.operators.auto import from_scipy_auto

__all__ = [
    "LinearOperator",
    "MatmatMixin",
    "CSROperator",
    "ELLOperator",
    "DIAOperator",
    "BSROperator",
    "BlockDIAOperator",
    "ConstBlockDIAOperator",
    "TiledOperator",
    "DenseOperator",
    "RealifiedHermitianOperator",
    "realify",
    "from_scipy_auto",
]
