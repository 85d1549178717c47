"""fai_mf family registration (port of focoos_tpu/models/fai_mf/__init__.py)."""

from focoos_tpu_torch.ports import ModelFamily


def _register():
    from focoos_tpu_torch.model_manager import BackboneManager, ConfigManager, ModelManager
    from focoos_tpu_torch.models.fai_mf.config import MaskFormerConfig
    from focoos_tpu_torch.processor.processor_manager import ProcessorManager

    ConfigManager.register(ModelFamily.MASKFORMER, MaskFormerConfig)

    def build(config: MaskFormerConfig):
        from focoos_tpu_torch.models.fai_mf.modelling import FAIMaskFormer

        return FAIMaskFormer(config=config, backbone=BackboneManager.from_config(config.backbone_config))

    ModelManager.register_model(ModelFamily.MASKFORMER, build)

    def processor_loader(config, image_size=None):
        from focoos_tpu_torch.models.fai_mf.processor import MaskFormerProcessor

        return MaskFormerProcessor(config, image_size)

    ProcessorManager.register(ModelFamily.MASKFORMER, processor_loader)
