"""Networks of the port: the detector, the physique net and the
discriminator, and the composed GAN losses."""
