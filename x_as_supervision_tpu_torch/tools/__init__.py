"""The port's tools.

The offline SMPL tools: the port's copies of the JAX package's
tools/{humanoid,surreal_constructor,render_campaign,campaign_manifest}.py,
and prng.py, its copy of the JAX random stream they draw from;
train_resumable.py, the hang-resilient driver of the train CLI.

The measurement tools, the port's copies of the JAX package's
tools/{bench_conv_bn,bench_serve,bench_resnet_control,bench_loader,
trace_opclass,scaling_projection}.py, on the card unless given
``--device cpu``: bench_conv_bn.py (the link kernel against its plain chain
and F.conv2d), bench_serve.py (PoseEstimator per batch size),
bench_resnet_control.py (a plain ResNet classifier step and its MFU),
bench_loader.py (the train CLI's feed against the device's demand),
trace_opclass.py (a profiled window's device time by op class),
scaling_projection.py (a train step's collectives and a projection onto
more cards), and measure.py, what they share (the device label, the card's
peaks and bound, the timer, the kernels' launch counters).
"""
