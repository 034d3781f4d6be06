"""Models of the port (GPT-2) and parameter conversion from the JAX
package's trees."""
