"""ldpc_tpu — neural LDPC decoding framework on JAX accelerators.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the reference
PyTorch implementation of "LDPC Decoding with Degree-Specific Neural Message
Weights and RCQ Decoding" (arXiv:2310.15483): degree-specific weight sharing
(N-NMS / N-OMS / N-2D types 1-4), reconstruction-computation-quantization
(RCQ / W-RCQ) decoding, posterior joint training, and Monte-Carlo FER/BER
evaluation — batched, jitted, and mesh-shardable.
"""

from ldpc_tpu.codes import (
    DecoderGraph,
    LDPCCode,
    build_graph,
    create_dvbs2_like_code,
    create_dvbs2_qc_protograph,
    create_pbrl_family,
    create_pbrl_qc_protograph,
    create_pbrl_like_code,
    create_peg_code,
    create_qc_code,
    create_tanner_155,
    create_array_code,
    tanner_155_base,
    gf2_rank,
    create_random_regular_code,
    create_test_ldpc_code,
    load_alist,
    load_protograph,
    save_alist,
    save_protograph,
)
from ldpc_tpu.channel import awgn_llr, bpsk_modulate, simulate_awgn_channel
from ldpc_tpu.encode import Encoder, make_encoder
from ldpc_tpu.quantizer import (
    NonUniformQuantizer,
    phase_schedule,
    power_thresholds,
    quantize_dequantize,
)
from ldpc_tpu.decode import (
    DecodeResult,
    Decoder,
    basic_min_sum,
    decode_batch,
    make_decoder,
    make_two_checkpoint_decoder,
    neural_2d_min_sum,
    neural_2d_offset_min_sum,
    neural_min_sum,
    neural_offset_min_sum,
    param_count,
    rcq_min_sum,
    weighted_oms_rcq,
    weighted_rcq,
)

from ldpc_tpu.sim import (
    LDPCSimulator,
    SimulationConfig,
    SimulationResult,
    create_test_decoders,
    simulate_single_snr,
)
from ldpc_tpu.train import (
    GradientExplosionAnalyzer,
    PosteriorJointTrainer,
    TrainingConfig,
    posterior_joint_loss,
)
from ldpc_tpu.zoo import list_pretrained, load_pretrained, save_pretrained

__version__ = "0.1.0"
