from ldpc_tpu.decode.engine import (
    DecodeResult,
    VariantSpec,
    decode_batch,
    decode_batch_layered,
    make_layers,
)
from ldpc_tpu.decode.variants import (
    Decoder,
    basic_min_sum,
    make_decoder,
    neural_2d_min_sum,
    neural_2d_offset_min_sum,
    neural_min_sum,
    neural_offset_min_sum,
    param_count,
    rcq_min_sum,
    weighted_oms_rcq,
    weighted_rcq,
)
from ldpc_tpu.decode.qc_engine import (
    QCGraph,
    build_qc_graph,
    qc_decode_batch,
    qc_decode_batch_layered,
)
from ldpc_tpu.decode.early_exit import make_two_checkpoint_decoder
