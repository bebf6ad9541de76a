from octave_tpu_torch.losses.gan import (
    LSDiscriminatorialLoss,
    LSGeneratorLoss,
    ls_discriminator_loss,
    ls_generator_loss,
)
from octave_tpu_torch.losses.segmentor import (
    CELoss,
    DiceLoss,
    ImageMseLoss,
    InterlayerDivergence,
    WeightedPartialCE,
    ce_loss,
    dice_loss,
    image_mse_loss,
    interlayer_divergence,
    weighted_partial_ce,
)
