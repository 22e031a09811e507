"""Device-side compute ops (the analog of the reference's shaders/)."""
