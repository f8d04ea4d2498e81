"""The data layer: sources, the weighted mix, the input pipeline, augment."""
