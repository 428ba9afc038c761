from cvnets_tpu_torch.data.loader.dataloader import CVNetsDataLoader  # noqa: F401
