from repro_torch.data.hdc import DataBundle, load_dataset, synthesize  # noqa: F401
