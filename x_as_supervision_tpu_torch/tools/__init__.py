"""The offline SMPL tools: the port's copies of the JAX package's
tools/{humanoid,surreal_constructor,render_campaign,campaign_manifest}.py,
and prng.py, its copy of the JAX random stream they draw from."""
