"""bisenetformer family registration (port of focoos_tpu/models/bisenetformer/__init__.py)."""

from focoos_tpu_torch.ports import ModelFamily


def _register():
    from focoos_tpu_torch.model_manager import BackboneManager, ConfigManager, ModelManager
    from focoos_tpu_torch.models.bisenetformer.config import BisenetFormerConfig
    from focoos_tpu_torch.processor.processor_manager import ProcessorManager

    ConfigManager.register(ModelFamily.BISENETFORMER, BisenetFormerConfig)

    def build(config: BisenetFormerConfig):
        from focoos_tpu_torch.models.bisenetformer.modelling import BisenetFormer

        return BisenetFormer(config=config, backbone=BackboneManager.from_config(config.backbone_config))

    ModelManager.register_model(ModelFamily.BISENETFORMER, build)

    def processor_loader(config, image_size=None):
        from focoos_tpu_torch.models.bisenetformer.processor import BisenetFormerProcessor

        return BisenetFormerProcessor(config, image_size)

    ProcessorManager.register(ModelFamily.BISENETFORMER, processor_loader)
