"""Model code of the port: the Llama decoder, paged attention, the
switch MoE and the convnet."""
