from octave_tpu_torch.models.discriminator import (
    DiscriminatorBlock,
    InstanceNoise,
    LabelNoise,
    SpectralConv,
)
from octave_tpu_torch.models.octa import OctaScribbleNet, octa_scribble_net
from octave_tpu_torch.models.propagation import (
    AdaptiveAggregationC,
    AdaptiveAggregationMulti,
    AdaptiveAggregationPC,
    BaseC,
    BaseMulti,
    BasePC,
    clip_by_tensor,
    extract_neighborhood,
    global_average_pooling_2d,
)
from octave_tpu_torch.models.resnest import (
    BasicBlock,
    Bottleneck,
    BuildResNet,
    ResNeSt,
    ResNeStConfig,
    ResNestDecoder,
    SplAtConv2d,
    Upsampling,
    resnest50,
)
from octave_tpu_torch.models.segmentor import (
    AdversarialAttentionGate,
    ResnestUNet,
    ResnestUnetParallelHead,
    ResnestUnetParallelHeadAttentionGate,
)
