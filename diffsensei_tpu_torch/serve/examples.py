"""The demo's preset inputs (port of ``diffsensei_tpu/serve/examples.py``):
prompt, height, width, samples, seed, character image paths and, for the
MLLM demo, the MLLM scale. The image files are not in the repository."""

example_inputs = [
    ["A young man with a surprised expression holding a baby on his back",
     224, 386, 1, 0,
     ["assets/example_images/young_man.png", "assets/example_images/baby.png"],
     0.4],
    ["A man with black hair talking with an older man with white hair",
     224, 312, 1, 0,
     ["assets/example_images/adult.png", "assets/example_images/old_man.png"],
     0.0],
]

example_inputs_wo_mllm = [row[:6] for row in example_inputs]
