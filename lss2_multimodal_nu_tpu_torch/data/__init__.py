"""The nu-A2D data pipeline: split tables, the nuScenes JSON index, a
baseline JPEG codec, the dataset, the loader and the synthetic fixture."""
